"""The port's twins of the TPU probe scripts in ``scripts/`` whose kernels
answer questions the card still had open, each on a hand-written CUDA
kernel of ``csrc/lab.cu`` (built into a library of its own by
``_kernels.py``):

  - ``fs_ops``: ``scripts/exp_fs_ops.py`` -- the shader's nine
    transcendental ops, kernel against the plain versions and against f64;
  - ``fs_chain``: ``scripts/exp_fs_mosaic_ops.py`` -- every intermediate of
    the shipped shader's chain at chosen pixels, card against CPU, and
    (``--from-scene``) at the pixels where a scene's card and CPU images
    differ;
  - ``slab_copy``: ``scripts/exp_lane_dma.py`` -- a 128-column slab of a
    wide array copied asynchronously into shared memory;
  - ``slab_transpose``: ``scripts/exp_transpose.py`` -- that slab
    transposed on chip, and its cost per iteration;
  - ``deposit_breakdown``, ``deposit_trip``, ``deposit_marginal``,
    ``loop_floor``: ``scripts/exp_deposit_breakdown.py``,
    ``exp_deposit3.py``, ``exp_deposit2.py``, ``exp_loop_floor.py`` -- the
    MXU deposit's loop bodies (``_bodies``) on one SM, ns per step, and
    E_exact: which products keep float32 bits;
  - ``mosaic_facts``: ``scripts/exp_mosaic_facts.py`` -- E1 to E5.

Run each as ``python -m vulkan_forge_torch.lab.<name>``; ``--device``
defaults to ``cuda`` (without a card a twin fails), ``--device cpu`` runs
the plain versions. None of this is on the render path.
"""
