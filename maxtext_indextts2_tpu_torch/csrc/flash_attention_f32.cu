// Flash attention, float32 q, k, v: the instantiations of K9-K11 in
// flash_attention.cuh (see the note there) behind plain C entry points. One
// source per element type so the two build in parallel.
#include "flash_attention.cuh"

FLASH_ENTRY_POINTS(f32, float)
