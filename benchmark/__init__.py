"""The benchmark of ``fastqdedup_tpu_torch``: back-to-back dedup jobs on
generated FASTQ input, checked against a plain NumPy reference.

Entry point: ``benchmark/run.py``; the cells are in ``BENCHMARK.json``.
"""
