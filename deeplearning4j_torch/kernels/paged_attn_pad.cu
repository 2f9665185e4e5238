// K2, the paged-KV attention read, at the head dims with no exact
// instantiation: any d with 4 <= d <= 128 and d % 4 == 0 runs the padded
// kernels of paged_attn.cuh (common.cuh), the decode route at the next
// power of two, the chunk route at the next of 8, 16, 32, 48, 64, 80, 96,
// 128. A translation unit of its own, so that it compiles beside
// paged_attn.cu.
#include "paged_attn.cuh"

namespace dl4j {

// the route and width switch for one (q type, pool type) pair; -2 for a
// head dim no kernel takes
template <typename QT, typename KV>
int launch_paged_pad_d(const void* q, const void* kp, const void* vp,
                       const float* kscales, const float* vscales,
                       const int* bt, const int* pos, const float* key_valid,
                       void* o, float* part, int splits, int B, int H, int T,
                       int D, int ps, int NP, cudaStream_t stream) {
#define DL4J_PAGED_ARGS \
  q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, ps, NP
#define DL4J_DECODE_PAD_ARGS \
  q, kp, vp, kscales, vscales, bt, pos, key_valid, o, B, H, T, ps, NP, D, stream
  if (T <= kDecodeMaxT) {
    switch (pad_dim_pow2(D)) {
      case 8:
        return launch_decode_pad<QT, KV, 8>(DL4J_DECODE_PAD_ARGS);
      case 16:
        return launch_decode_pad<QT, KV, 16>(DL4J_DECODE_PAD_ARGS);
      case 32:
        return launch_decode_pad<QT, KV, 32>(DL4J_DECODE_PAD_ARGS);
      case 64:
        return launch_decode_pad<QT, KV, 64>(DL4J_DECODE_PAD_ARGS);
      case 128:
        return launch_decode_pad<QT, KV, 128>(DL4J_DECODE_PAD_ARGS);
      default:
        return -2;
    }
  }
  switch (pad_dim(D)) {
    case 8:
      return launch_chunk_pad<QT, KV, 8>(DL4J_PAGED_ARGS, D, stream);
    case 16:
      return launch_chunk_pad<QT, KV, 16>(DL4J_PAGED_ARGS, D, stream);
    case 32:
      return launch_chunk_pad<QT, KV, 32>(DL4J_PAGED_ARGS, D, stream);
    case 48:
      return launch_chunk_pad<QT, KV, 48>(DL4J_PAGED_ARGS, D, stream);
    case 64:
      return launch_chunk_pad<QT, KV, 64>(DL4J_PAGED_ARGS, D, stream);
    case 80:
      return launch_chunk_pad<QT, KV, 80>(DL4J_PAGED_ARGS, D, stream);
    case 96:
      return launch_chunk_pad<QT, KV, 96>(DL4J_PAGED_ARGS, D, stream);
    case 128:
      return launch_chunk_pad<QT, KV, 128>(DL4J_PAGED_ARGS, D, stream);
    default:
      return -2;
  }
#undef DL4J_DECODE_PAD_ARGS
#undef DL4J_PAGED_ARGS
}

// pools of q's own type, or int8 codes
template <typename QT>
int launch_paged_pad_kv(const void* q, const void* kp, const void* vp,
                        const float* kscales, const float* vscales,
                        const int* bt, const int* pos, const float* key_valid,
                        void* o, float* part, int splits, int B, int H, int T,
                        int D, int ps, int NP, int quant,
                        cudaStream_t stream) {
  return quant ? launch_paged_pad_d<QT, int8_t>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream)
               : launch_paged_pad_d<QT, QT>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
}

}  // namespace dl4j

// K2 at a padded head dim; arguments and return codes as dl4j_paged_attn
// (paged_attn.cu), which checks them and calls this for any D that has no
// exact instantiation.
extern "C" int dl4j_paged_attn_pad(const void* q, const void* kp,
                                   const void* vp, const float* kscales,
                                   const float* vscales, const int* bt,
                                   const int* pos, const float* key_valid,
                                   void* o, float* part, int splits, int B,
                                   int H, int T, int D, int ps, int NP,
                                   int qtype, int quant, cudaStream_t stream) {
  switch (qtype) {
    case 0:
      return dl4j::launch_paged_pad_kv<float>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 1:
      return dl4j::launch_paged_pad_kv<__nv_bfloat16>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 2:
      return dl4j::launch_paged_pad_kv<__half>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    default:
      return -5;
  }
}
