"""The port's share of `avenir_tpu/analysis/`: the admission oracle.

Only `mem.py`'s analytic footprint model and its RSS sampler are ported
(the job server prices every dispatch with them, and the server tripwire
samples the served phase's RSS). The lint rules, the jaxpr lowering and
the footprint audit wait (`ROADMAP.md` item 8).
"""
