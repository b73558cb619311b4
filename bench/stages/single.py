"""The single-device partitioner's calls (``backend="single"``, one
request a call) that ``bench/reference/single.py`` replays, in the words
of the recorder: each stage's kind, the module attribute the program
calls it through, and the arrays of its result that are compared.
``deep_mgp.partition`` reaches every one of them through its module's
namespace, and so does ``extend_partition`` its sibling-restricted
refinements."""

CORE = "repro_torch.core.deep_mgp"


def graph(g) -> list:
    return [g.indptr, g.adjncy, g.eweights, g.vweights]


STAGES = [
    ("cluster", CORE, "cluster", lambda out: [out]),
    ("contract", CORE, "contract", lambda out: [out[1]] + graph(out[0])),
    ("initial", CORE, "partition_into_counts", lambda out: [out]),
    ("extend", CORE, "extend_partition", lambda out: [out[0]]),
    ("refine", CORE, "balance_and_refine", lambda out: [out]),
]
