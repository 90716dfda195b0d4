"""graph_s: seconds of the build's kernel weights and symmetrize to ELL
(phases ``weights`` + ``symmetrize``: ops/distance.py::kernel_weights,
ops/symmetrize.py), the program's own phase timings, averaged over the
window's builds."""

PHASES = ("weights", "symmetrize")


def read(ctx):
    vals = [sum(r["phases"][p] for p in PHASES) for r in ctx.records
            if all(p in r.get("phases", {}) for p in PHASES)]
    return sum(vals) / len(vals) if vals else None
