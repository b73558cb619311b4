"""dKaMinPar core on PyTorch: the port of ``repro.core``.

Kept free of eager imports so that the kernel modules, which build on
``core.lp``, import without a cycle."""
