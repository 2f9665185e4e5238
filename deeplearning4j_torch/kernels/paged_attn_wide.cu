// K2, the paged-KV attention read, at the head dims past 128: exactly 256
// in its own instantiations, any other d with 129 <= d <= 256 in the
// padded kernels of paged_attn.cuh (common.cuh), the decode route at 256,
// the chunk route at the next of 160, 192, 224, 256. A translation unit of
// its own, so that it compiles beside paged_attn.cu, which calls it.
#include "paged_attn.cuh"

namespace dl4j {

// the route and width switch for one (q type, pool type) pair; -2 for a
// head dim no kernel takes
template <typename QT, typename KV>
int launch_paged_wide_d(const void* q, const void* kp, const void* vp,
                        const float* kscales, const float* vscales,
                        const int* bt, const int* pos, const float* key_valid,
                        void* o, float* part, int splits, int B, int H, int T,
                        int D, int ps, int NP, cudaStream_t stream) {
#define DL4J_PAGED_ARGS \
  q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, ps, NP
  if (D == 256)
    return launch_paged<QT, KV, 256>(DL4J_PAGED_ARGS, stream);
  if (T <= kDecodeMaxT)
    return pad_dim_pow2(D) == 256
               ? launch_decode_pad<QT, KV, 256>(q, kp, vp, kscales, vscales,
                                                bt, pos, key_valid, o, B, H,
                                                T, ps, NP, D, stream)
               : -2;
  switch (pad_dim(D)) {
    case 160:
      return launch_chunk_pad<QT, KV, 160>(DL4J_PAGED_ARGS, D, stream);
    case 192:
      return launch_chunk_pad<QT, KV, 192>(DL4J_PAGED_ARGS, D, stream);
    case 224:
      return launch_chunk_pad<QT, KV, 224>(DL4J_PAGED_ARGS, D, stream);
    case 256:
      return launch_chunk_pad<QT, KV, 256>(DL4J_PAGED_ARGS, D, stream);
    default:
      return -2;
  }
#undef DL4J_PAGED_ARGS
}

// pools of q's own type, or int8 codes
template <typename QT>
int launch_paged_wide_kv(const void* q, const void* kp, const void* vp,
                         const float* kscales, const float* vscales,
                         const int* bt, const int* pos,
                         const float* key_valid, void* o, float* part,
                         int splits, int B, int H, int T, int D, int ps,
                         int NP, int quant, cudaStream_t stream) {
  return quant ? launch_paged_wide_d<QT, int8_t>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream)
               : launch_paged_wide_d<QT, QT>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
}

}  // namespace dl4j

// K2 at a head dim of 129..256; arguments and return codes as
// dl4j_paged_attn (paged_attn.cu), which checks them and calls this.
extern "C" int dl4j_paged_attn_wide(const void* q, const void* kp,
                                    const void* vp, const float* kscales,
                                    const float* vscales, const int* bt,
                                    const int* pos, const float* key_valid,
                                    void* o, float* part, int splits, int B,
                                    int H, int T, int D, int ps, int NP,
                                    int qtype, int quant,
                                    cudaStream_t stream) {
  switch (qtype) {
    case 0:
      return dl4j::launch_paged_wide_kv<float>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 1:
      return dl4j::launch_paged_wide_kv<__nv_bfloat16>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 2:
      return dl4j::launch_paged_wide_kv<__half>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    default:
      return -5;
  }
}

// dl4j_paged_chunk_smem (paged_attn.cu) at the widths past 128
extern "C" int dl4j_paged_chunk_wide_smem(int D, int kind, int NP) {
  switch (dl4j::pad_dim(D)) {
    case 160:
      return dl4j::chunk_smem_kind<160>(kind, NP);
    case 192:
      return dl4j::chunk_smem_kind<192>(kind, NP);
    case 224:
      return dl4j::chunk_smem_kind<224>(kind, NP);
    case 256:
      return dl4j::chunk_smem_kind<256>(kind, NP);
    default:
      return -2;
  }
}
