"""The corpus and the queries of a run, made on the run's device from
``--seed`` with ``torch.Generator``s, in a few large calls.

Laws (a configuration's "corpus" and "queries" entries):
  gaussian     rows N(0, 1) x scale (bench.py's 313,841 x 384 recipe, drawn
               on the card instead of by numpy)
  mixture      ``centres`` N(0, 1) centres, each row a uniformly drawn centre
               + noise x N(0, 1), all x scale (benchmarks/bench_serving.py's
               and chip_smoke.py::_mixture_rows's recipe)
  corpus_noise queries: a uniformly drawn corpus row + noise x scale x N(0, 1)
  mixture      queries: a uniformly drawn centre + noise x N(0, 1), x scale

The corpus and the queries each draw from a generator of their own, so the
same seed gives the same corpus whatever the queries, and every seed gives
the same sizes.
"""

from __future__ import annotations

import hashlib

CORPUS_STREAM, QUERY_STREAM, SAMPLE_STREAM = 0, 1, 2


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of one run's seed (any whole number)."""
    digest = hashlib.sha256(f"perfbench:{int(seed)}:{stream}".encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


def generator(torch, device, seed: int, stream: int):
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def make_corpus(torch, device, config: dict, seed: int):
    """(x [n, f] float32, centres or None) of the configuration's law."""
    law = config["corpus"]
    n, f = int(config["n_items"]), int(config["n_features"])
    gen = generator(torch, device, seed, CORPUS_STREAM)
    scale = float(law.get("scale", 1.0))
    if law["law"] == "gaussian":
        x = torch.randn((n, f), generator=gen, device=device)
        return x.mul_(scale), None
    if law["law"] == "mixture":
        centres = torch.randn((int(law["centres"]), f), generator=gen,
                              device=device)
        pick = torch.randint(0, centres.shape[0], (n,), generator=gen,
                             device=device)
        x = torch.randn((n, f), generator=gen, device=device)
        x.mul_(float(law["noise"])).add_(centres[pick])
        return x.mul_(scale), centres
    raise ValueError(f"unknown corpus law {law['law']!r}")


def make_queries(torch, device, config: dict, seed: int, x, centres,
                 batches: int, q: int) -> list:
    """``batches`` query batches of [q, f] float32 of the configuration's
    query law."""
    law = config["queries"]
    gen = generator(torch, device, seed, QUERY_STREAM)
    f = x.shape[1]
    scale = float(config["corpus"].get("scale", 1.0))
    out = []
    for _ in range(batches):
        if law["law"] == "corpus_noise":
            rows = torch.randint(0, x.shape[0], (q,), generator=gen,
                                 device=device)
            noise = torch.randn((q, f), generator=gen, device=device)
            out.append(x[rows] + (float(law["noise"]) * scale) * noise)
        elif law["law"] == "mixture":
            pick = torch.randint(0, centres.shape[0], (q,), generator=gen,
                                 device=device)
            noise = torch.randn((q, f), generator=gen, device=device)
            out.append((centres[pick] + float(law["noise"]) * noise) * scale)
        else:
            raise ValueError(f"unknown query law {law['law']!r}")
    return out
