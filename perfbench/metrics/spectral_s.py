"""spectral_s: seconds of the build's reduction, feature Laplacian and
lambdas (phases ``reduction`` + ``feature_laplacian`` + ``lambdas``:
reduction/pipeline.py, graph/feature.py, ops/rayleigh.py,
spectral/taumode.py), the program's own phase timings, averaged over the
window's builds.  A build below the reduction's size has no ``reduction``
phase; the other two are then summed."""

PHASES = ("reduction", "feature_laplacian", "lambdas")


def read(ctx):
    vals = [sum(r["phases"].get(p, 0.0) for p in PHASES) for r in ctx.records
            if "lambdas" in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
