"""Set-up child of a benchmark run: look for the cards, then build the
port's kernel library and its native I/O library.

``python3 benchmark/build.py CHIPS`` prints one JSON line with the CUDA
devices it sees; it exits 3 without ``CHIPS`` of them and builds nothing.
Both libraries go to ``fastqdedup_tpu_torch/build/`` inside the
checkout, where later runs find them by their sources' digest and mtime:
only the first run of a checkout compiles.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(chips: int) -> int:
    sys.path.insert(0, ROOT)
    import torch

    found = {"cuda": torch.cuda.is_available(),
             "count": torch.cuda.device_count()
             if torch.cuda.is_available() else 0}
    print(json.dumps(found), flush=True)
    if not found["cuda"] or found["count"] < chips:
        return 3
    from fastqdedup_tpu_torch.native.build import library_path
    from fastqdedup_tpu_torch.ops.kernel_lib import build_kernels

    library_path()
    _, log = build_kernels()
    if log:
        print(log, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1])))
