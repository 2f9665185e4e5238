// K1, the flash-attention forward (flash_fwd.cuh), at the wide widths 160,
// 192, 224 and 256 (exact at 256): two CTAs per q tile, one per half of
// O's columns. A translation unit of its own, so that it compiles beside
// flash_fwd.cu, which calls it.
#include "flash_fwd.cuh"

// dl4j_flash_fwd for a head dim of 129..256: arguments and return codes
// as there
extern "C" int dl4j_flash_fwd_wide(const void* q, const void* k,
                                   const void* v, const float* mask, void* o,
                                   float* lse, int B, int H, int Tlen, int D,
                                   int dtype, int causal,
                                   cudaStream_t stream) {
  if (D == 256) {
    switch (D) { DL4J_FWD_CASE(256, false) }
  }
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_CASE(160, true)
    DL4J_FWD_CASE(192, true)
    DL4J_FWD_CASE(224, true)
    DL4J_FWD_CASE(256, true)
    default:
      return -2;
  }
}

// dl4j_flash_fwd_smem at the wide widths
extern "C" int dl4j_flash_fwd_wide_smem(int D, int dtype) {
  switch (dl4j::pad_dim(D)) {
    DL4J_FWD_SMEM(160)
    DL4J_FWD_SMEM(192)
    DL4J_FWD_SMEM(224)
    DL4J_FWD_SMEM(256)
    default:
      return -2;
  }
}
