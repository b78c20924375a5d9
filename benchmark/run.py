"""Run one cell of the benchmark of ``fastqdedup_tpu_torch`` once.

    python3 benchmark/run.py --workload hamming-d1.dense --seed 12345 \\
        --seconds 30 --trace 0

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result (JSON); the numbers
compared with the plain reference are the last lines of standard error.
Without the cards it exits 2 and prints no result.  See
``benchmark/harness.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
