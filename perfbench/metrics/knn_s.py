"""knn_s: seconds of the build's exact k-NN phase (``arrowspace:knn``: K1
through ops/distance.py -> ops/cuda/knn.py -> csrc/knn.cu), the program's
own phase timing, averaged over the window's builds."""


def read(ctx):
    vals = [r["phases"]["knn"] for r in ctx.records
            if "knn" in r.get("phases", {})]
    return sum(vals) / len(vals) if vals else None
