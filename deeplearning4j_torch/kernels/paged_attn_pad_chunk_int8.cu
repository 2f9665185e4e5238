// K2's chunk route at the padded head dims up to 128 over int8 pages:
// paged_attn_pad_chunk.cu compiled with DL4J_CHUNK_PAD_INT8, a translation
// unit of its own so that it compiles beside the others.
#define DL4J_CHUNK_PAD_INT8
#include "paged_attn_pad_chunk.cu"
