"""host_syncs: the program's blocking waits for the device per call, its
``syncs`` counter: synchronizes, host reads of CUDA tensors and blocking
host-to-device copies."""

from ..program import per_call


def read(reading):
    return per_call("syncs")
