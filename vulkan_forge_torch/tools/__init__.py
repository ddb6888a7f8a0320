"""The reference's six CLI tools (``python/tools/*.py``) as twins on torch.

Run each as ``python -m vulkan_forge_torch.tools.<name>``:
``device_diagnostics``, ``terrain_spike``, ``determinism_harness``,
``perf_sanity``, ``backends_runner``, ``parity_report``. Each keeps its
original's flags, JSON report and exit policy, adds ``--device`` (default
``cuda``: without a card a twin fails, except ``device_diagnostics``, whose
job is to report it), and writes to default paths of its own (``*_torch``)
so that it never overwrites an original's artifact.
"""
