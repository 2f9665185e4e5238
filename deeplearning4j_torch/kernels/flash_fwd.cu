// K1, the flash-attention forward (flash_fwd.cuh): the widths up to 128
// and the C entry points; the wide widths are in flash_fwd_wide.cu.
#include "flash_fwd.cuh"

// flash_fwd_wide.cu: K1 at a head dim of 129..256, the arguments and
// return codes of dl4j_flash_fwd
extern "C" int dl4j_flash_fwd_wide(const void* q, const void* k,
                                   const void* v, const float* mask, void* o,
                                   float* lse, int B, int H, int Tlen, int D,
                                   int dtype, int causal,
                                   cudaStream_t stream);
extern "C" int dl4j_flash_fwd_wide_smem(int D, int dtype);

// Launches K1 on `stream`; returns 0 after a launch (the caller checks it
// with cudaGetLastError), or a nonzero code for an unsupported
// configuration, which launches nothing (-2: a head dim D no kernel
// takes). dtype: q's, k's, v's and o's type, 0 f32, 1 bf16, 2 f16.
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
                              const float* mask, void* o, float* lse, int B,
                              int H, int Tlen, int D, int dtype, int causal,
                              cudaStream_t stream) {
  if (Tlen < 1 || B * H < 1 || B * H > 65535) return -1;
  if (dl4j::pad_dim(D) > 128)
    return dl4j_flash_fwd_wide(q, k, v, mask, o, lse, B, H, Tlen, D, dtype,
                               causal, stream);
  if (dl4j::exact_dim(D)) {
    switch (D) {
      DL4J_FWD_CASE(8, false)
      DL4J_FWD_CASE(16, false)
      DL4J_FWD_CASE(32, false)
      DL4J_FWD_CASE(64, false)
      DL4J_FWD_CASE(128, false)
    }
  }
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_CASE(8, true)
    DL4J_FWD_CASE(16, true)
    DL4J_FWD_CASE(32, true)
    DL4J_FWD_CASE(48, true)
    DL4J_FWD_CASE(64, true)
    DL4J_FWD_CASE(80, true)
    DL4J_FWD_CASE(96, true)
    DL4J_FWD_CASE(128, true)
    default:
      return -2;
  }
}

// Dynamic shared memory of one K1 CTA in bytes (for reports) at the width a
// head dim D runs at; dtype as for dl4j_flash_fwd; -2 for a head dim no
// kernel takes.
extern "C" int dl4j_flash_fwd_smem(int D, int dtype) {
  if (dl4j::pad_dim(D) > 128) return dl4j_flash_fwd_wide_smem(D, dtype);
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_SMEM(8)
    DL4J_FWD_SMEM(16)
    DL4J_FWD_SMEM(32)
    DL4J_FWD_SMEM(48)
    DL4J_FWD_SMEM(64)
    DL4J_FWD_SMEM(80)
    DL4J_FWD_SMEM(96)
    DL4J_FWD_SMEM(128)
    default:
      return -2;
  }
}
