"""Seconds a request spends in the program's host-side preparation of
device work: relabelling and ordering graphs, cutting chunks, building
the kernels' ELL slabs. The union of the benchmark's spans around those
calls (nested calls count once), averaged over the window's requests."""

SPANS = [("host_prep", "repro_torch.core.coarsening", "permute"),
         ("host_prep", "repro_torch.core.coarsening", "degree_bucket_order"),
         ("host_prep", "repro_torch.core.refinement", "permute"),
         ("host_prep", "repro_torch.core.refinement", "degree_bucket_order"),
         ("host_prep", "repro_torch.core.lp", "build_chunks"),
         ("host_prep", "repro_torch.kernels.lp_move.ops",
          "build_move_chunks"),
         ("host_prep", "repro_torch.kernels.bal_round.ops",
          "build_balance_ell")]


def read(run):
    spans = sorted((t0, t1) for name, t0, t1 in run.spans
                   if name == "host_prep")
    total, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total / len(run.requests)
