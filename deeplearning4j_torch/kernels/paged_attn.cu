// K2, the paged-KV attention read: the exact head dims 8, 16, 32, 64 and
// 128 and the C entry points; the kernels, their design and their
// launchers are in paged_attn.cuh, the padded head dims in
// paged_attn_pad.cu.
#include "paged_attn.cuh"

// paged_attn_pad.cu: K2 at a head dim D with no exact instantiation, the
// arguments and return codes of dl4j_paged_attn
extern "C" int dl4j_paged_attn_pad(const void* q, const void* kp,
                                   const void* vp, const float* kscales,
                                   const float* vscales, const int* bt,
                                   const int* pos, const float* key_valid,
                                   void* o, float* part, int splits, int B,
                                   int H, int T, int D, int ps, int NP,
                                   int qtype, int quant, cudaStream_t stream);

namespace dl4j {

// the head-dim switch for one (q type, pool type) pair at the exact head
// dims; -2 for any other
template <typename QT, typename KV>
int launch_paged_d(const void* q, const void* kp, const void* vp,
                   const float* kscales, const float* vscales, const int* bt,
                   const int* pos, const float* key_valid, void* o,
                   float* part, int splits, int B, int H, int T, int D,
                   int ps, int NP, cudaStream_t stream) {
#define DL4J_PAGED_ARGS \
  q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, ps, NP, stream
  switch (D) {
    case 8:
      return launch_paged<QT, KV, 8>(DL4J_PAGED_ARGS);
    case 16:
      return launch_paged<QT, KV, 16>(DL4J_PAGED_ARGS);
    case 32:
      return launch_paged<QT, KV, 32>(DL4J_PAGED_ARGS);
    case 64:
      return launch_paged<QT, KV, 64>(DL4J_PAGED_ARGS);
    case 128:
      return launch_paged<QT, KV, 128>(DL4J_PAGED_ARGS);
    default:
      return -2;
  }
#undef DL4J_PAGED_ARGS
}

// pools of q's own type, or int8 codes
template <typename QT>
int launch_paged_kv(const void* q, const void* kp, const void* vp,
                    const float* kscales, const float* vscales, const int* bt,
                    const int* pos, const float* key_valid, void* o,
                    float* part, int splits, int B, int H, int T, int D,
                    int ps, int NP, int quant, cudaStream_t stream) {
  return quant ? launch_paged_d<QT, int8_t>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream)
               : launch_paged_d<QT, QT>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
}

}  // namespace dl4j

// How many ranges the chunk route cuts each q tile's walk into: 1 (no
// workspace) for the decode route and wherever the grid has at least one
// CTA per SM; else enough for about two CTAs per SM, at most one range per
// two key tiles of a full walk. kind: the pools' element, 0 f32, 1 int8
// codes, 2 bf16/f16 (it sets the key tile, with the head dim D).
extern "C" int dl4j_paged_attn_splits(int B, int H, int T, int D, int ps,
                                      int NP, int kind) {
  if (T <= dl4j::kDecodeMaxT || B < 1 || H < 1 || ps < 1 || NP < 1) return 1;
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 1;
    return n;
  }();
  const long long ctas = (long long)B * H *
                         ((T + dl4j::kChunkRows - 1) / dl4j::kChunkRows);
  if (ctas >= sms) return 1;
  // ChunkTile::kBlockN of the width D runs at
  const int bn = (dl4j::pad_dim(D) > 64 && kind != 2) ? 32 : 64;
  const long long most = std::max(1LL, ((long long)NP * ps) / (2 * bn));
  return (int)std::min(most, (2LL * sms + ctas - 1) / ctas);
}

namespace dl4j {
template <int D>
int chunk_smem_kind(int kind, int NP) {
  switch (kind) {
    case 0:
      return chunk_smem_bytes<float, D>(NP);
    case 1:
      return chunk_smem_bytes<int8_t, D>(NP);
    case 2:
      return chunk_smem_bytes<__nv_bfloat16, D>(NP);
    default:
      return -2;
  }
}
}  // namespace dl4j

// Dynamic shared memory of one chunk-route CTA in bytes (for reports), at
// the width a head dim D runs at; kind as for dl4j_paged_attn_splits.
extern "C" int dl4j_paged_chunk_smem(int D, int kind, int NP) {
  switch (dl4j::pad_dim(D)) {
    case 8:
      return dl4j::chunk_smem_kind<8>(kind, NP);
    case 16:
      return dl4j::chunk_smem_kind<16>(kind, NP);
    case 32:
      return dl4j::chunk_smem_kind<32>(kind, NP);
    case 48:
      return dl4j::chunk_smem_kind<48>(kind, NP);
    case 64:
      return dl4j::chunk_smem_kind<64>(kind, NP);
    case 80:
      return dl4j::chunk_smem_kind<80>(kind, NP);
    case 96:
      return dl4j::chunk_smem_kind<96>(kind, NP);
    case 128:
      return dl4j::chunk_smem_kind<128>(kind, NP);
    default:
      return -2;
  }
}

// Launches K2 on `stream`; returns 0 after a launch (the caller checks it
// with cudaGetLastError), or a nonzero code for an unsupported
// configuration, which launches nothing. qtype: q's and o's type, 0 f32, 1
// bf16, 2 f16; the pools are of that type, or int8 codes when quant is set
// (then kscales/vscales are read). key_valid may be null. With splits > 1
// (chunk route only), part is a workspace of splits·B·H·T·(D + 2) floats.
extern "C" int dl4j_paged_attn(const void* q, const void* kp, const void* vp,
                               const float* kscales, const float* vscales,
                               const int* bt, const int* pos,
                               const float* key_valid, void* o, float* part,
                               int splits, int B, int H, int T, int D, int ps,
                               int NP, int qtype, int quant,
                               cudaStream_t stream) {
  if (T < 1 || B < 1 || H < 1 || ps < 1 || NP < 1 || B > 65535 || H > 65535)
    return -1;
  if (splits < 1 || (splits > 1 && (part == nullptr || T <= dl4j::kDecodeMaxT)))
    return -4;
  if (!dl4j::exact_dim(D))
    return dl4j_paged_attn_pad(q, kp, vp, kscales, vscales, bt, pos,
                               key_valid, o, part, splits, B, H, T, D, ps, NP,
                               qtype, quant, stream);
  switch (qtype) {
    case 0:
      return dl4j::launch_paged_kv<float>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 1:
      return dl4j::launch_paged_kv<__nv_bfloat16>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    case 2:
      return dl4j::launch_paged_kv<__half>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, quant, stream);
    default:
      return -5;
  }
}
