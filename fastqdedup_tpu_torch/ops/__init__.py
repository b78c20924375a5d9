"""Device-side compute ops (PyTorch tensors and hand-written CUDA kernels).

* :mod:`.hamming_kernels` — the three Hamming kernels (``csrc/hamming.cu``)
  with their plain PyTorch versions and launch counters;
* :mod:`.hamming` — tile sweeps and pair verification over them;
* :mod:`.edit_kernels` — the banded Levenshtein kernel (``csrc/edit.cu``)
  with its plain PyTorch version and launch counter;
* :mod:`.edit` — batched edit distance and candidate verification;
* :mod:`.kernel_lib` — builds every ``csrc/*.cu`` into one library and
  binds it;
* :mod:`.bucket` — pigeonhole candidate generation (Hamming buckets and
  the shifted-segment edit candidates);
* :mod:`.components` — host union-find and the device label
  propagation that parallel/sharded.py runs on a mesh of devices;
* :mod:`.phred` — the opt-in device quality filter;
* :mod:`.encode` — the alphabet table and nibble packing;
* :mod:`.transfer` — pinned, ``non_blocking`` copies to and from the
  card, read back after an event.
"""
