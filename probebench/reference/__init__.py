"""Plain reference of the probes the benchmark judges; imports nothing of the program.

Where ``probes.py`` departs from the program's computation, and why:

* burn chain: each product of bf16 values in float32 with TF32 off, where
  cuBLAS accumulates in float32 in another order; the checksum in float64
  (the program sums in float32 on the card).  The order differs, so the
  last product's bf16 roundings differ now and then: the gap is compared
  with a limit, not exactly.
* invariant: ||A||_F^2 once, in float64, for both of the probe's sides
  (its tensor-core trace(A A^T) and its float32 elementwise sum).
* tiled matmul: float64 dot products at the sampled entries only, not the
  tiled wgmma kernel's float32 tiles: a sample is enough to see a wrong tile.
* flash attention: the whole causal softmax in float64, not the kernel's
  blockwise online softmax with P rounded to bf16 before P·V: the gap that
  rounding leaves is what the limit allows.
* int8 chain: one float64 product (exact: every partial sum is far below
  2**53), rolled and summed, not ``iters`` int32 products.
* DMA stream, HBM stream, memtest: closed forms (2x + 1 in float32; the
  pass count; the patterns in NumPy's unsigned arithmetic), exact.
"""
