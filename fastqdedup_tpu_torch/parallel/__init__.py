"""Multi-device and multi-process scaling over torch.distributed.

Counterpart of ``fastqdedup_tpu/parallel``: work partitioning and host
byte exchanges across processes (:mod:`.distributed`, over the socket
mesh of :mod:`.transport` or gloo collectives), and component labels
across several devices (:mod:`.sharded`).
"""
