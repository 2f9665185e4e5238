// K2's chunk route at the head dims up to 128 with no exact instantiation
// (paged_attn_pad.cu holds the decode route and calls this): the padded
// kernels of paged_attn.cuh at the next of 8, 16, 32, 48, 64, 80, 96, 128,
// over pages of q's own type; paged_attn_pad_chunk_int8.cu compiles this
// file again with DL4J_CHUNK_PAD_INT8 for int8 pages. Translation units of
// their own, so that they compile beside the others.
#include "paged_attn.cuh"

namespace dl4j {

// the width switch for one (q type, pool type) pair; -2 for a head dim no
// kernel takes
template <typename QT, typename KV>
int launch_chunk_pad_d(const void* q, const void* kp, const void* vp,
                       const float* kscales, const float* vscales,
                       const int* bt, const int* pos, const float* key_valid,
                       void* o, float* part, int splits, int B, int H, int T,
                       int D, int ps, int NP, cudaStream_t stream) {
#define DL4J_PAGED_ARGS \
  q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, ps, NP, D, stream
  switch (pad_dim(D)) {
    case 8:
      return launch_chunk_pad<QT, KV, 8>(DL4J_PAGED_ARGS);
    case 16:
      return launch_chunk_pad<QT, KV, 16>(DL4J_PAGED_ARGS);
    case 32:
      return launch_chunk_pad<QT, KV, 32>(DL4J_PAGED_ARGS);
    case 48:
      return launch_chunk_pad<QT, KV, 48>(DL4J_PAGED_ARGS);
    case 64:
      return launch_chunk_pad<QT, KV, 64>(DL4J_PAGED_ARGS);
    case 80:
      return launch_chunk_pad<QT, KV, 80>(DL4J_PAGED_ARGS);
    case 96:
      return launch_chunk_pad<QT, KV, 96>(DL4J_PAGED_ARGS);
    case 128:
      return launch_chunk_pad<QT, KV, 128>(DL4J_PAGED_ARGS);
    default:
      return -2;
  }
#undef DL4J_PAGED_ARGS
}

}  // namespace dl4j

#ifndef DL4J_CHUNK_PAD_INT8
// paged_attn_pad_chunk_int8.cu: the same over int8 pages (arguments as
// below, quant set)
extern "C" int dl4j_paged_attn_pad_chunk_int8(
    const void* q, const void* kp, const void* vp, const float* kscales,
    const float* vscales, const int* bt, const int* pos,
    const float* key_valid, void* o, float* part, int splits, int B, int H,
    int T, int D, int ps, int NP, int qtype, cudaStream_t stream);

// dl4j_paged_attn_pad's chunk route (T > 4) over pages of q's own type;
// int8 pages in paged_attn_pad_chunk_int8.cu
extern "C" int dl4j_paged_attn_pad_chunk(
    const void* q, const void* kp, const void* vp, const float* kscales,
    const float* vscales, const int* bt, const int* pos,
    const float* key_valid, void* o, float* part, int splits, int B, int H,
    int T, int D, int ps, int NP, int qtype, int quant, cudaStream_t stream) {
  if (quant)
    return dl4j_paged_attn_pad_chunk_int8(q, kp, vp, kscales, vscales, bt,
                                          pos, key_valid, o, part, splits, B,
                                          H, T, D, ps, NP, qtype, stream);
#define DL4J_KV(QT) QT
#else
// paged_attn_pad_chunk.cu's chunk route over int8 pages
extern "C" int dl4j_paged_attn_pad_chunk_int8(
    const void* q, const void* kp, const void* vp, const float* kscales,
    const float* vscales, const int* bt, const int* pos,
    const float* key_valid, void* o, float* part, int splits, int B, int H,
    int T, int D, int ps, int NP, int qtype, cudaStream_t stream) {
#define DL4J_KV(QT) int8_t
#endif
  switch (qtype) {
    case 0:
      return dl4j::launch_chunk_pad_d<float, DL4J_KV(float)>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
    case 1:
      return dl4j::launch_chunk_pad_d<__nv_bfloat16, DL4J_KV(__nv_bfloat16)>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
    case 2:
      return dl4j::launch_chunk_pad_d<__half, DL4J_KV(__half)>(q, kp, vp, kscales, vscales, bt, pos, key_valid, o, part, splits, B, H, T, D, ps, NP, stream);
    default:
      return -5;
  }
#undef DL4J_KV
}
