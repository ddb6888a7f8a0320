"""vfbench: the benchmark of the PyTorch/CUDA port, ``vulkan_forge_torch``.

Run one cell once, from the root of a checkout::

    python3 -m vfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from files: its configuration in
``configs/``, its traffic mix in ``traffic/``, the driver of the mix's
public entry in ``drivers/``, its correctness limits in ``limits/`` and
each per-layer metric's reader in ``metrics/``.
"""
