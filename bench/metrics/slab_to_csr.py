"""Bytes of level 0's LP-move chunk slabs and overflow, as the program
builds them (``build_move_chunks``), over the bytes of the graph's CSR
(int64 offsets, int32 heads, int64 weights), averaged over the window's
requests: how far the kernels' layout blows up the input on the card."""


def read(run):
    ratios = [slab / csr for _, slab, csr in run.slabs]
    return sum(ratios) / len(ratios) if ratios else None
