"""Device-side compute ops (PyTorch tensors and hand-written CUDA kernels).

* :mod:`.hamming_kernels` — the three Hamming kernels (``csrc/hamming.cu``)
  with their plain PyTorch versions and launch counters;
* :mod:`.hamming` — tile sweeps and pair verification over them;
* :mod:`.bucket` — pigeonhole candidate generation;
* :mod:`.components` — host union-find;
* :mod:`.encode` — the alphabet table and nibble packing.
"""
