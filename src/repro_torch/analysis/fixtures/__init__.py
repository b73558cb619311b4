"""Seeded-violation fixtures proving each analysis pass fires.

Each module runs (or merely contains, for the AST lint) exactly the
defect its pass exists to catch; ``python -m repro_torch.analysis
--fixture <name>`` must exit nonzero on every one of them. Excluded from
the normal repo sweep; importing one runs nothing.
"""
