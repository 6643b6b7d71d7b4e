"""score_idle_ms.roundtrip: the t-ops scores' host reads, ms a round trip:
the device's idle gaps between each traced round trip's synchronized
reconstruction and its end whose midpoint the host spent inside a
`score.psnr`, `score.ssim` or `score.lpips` span (evaluation/metrics.py,
evaluation/lpips.py), leaving out those in the profiler's own buffer
flushes, over the round trips. Moves roundtrip_s."""
from benchmark.spans import idle_ms, score_parts


def read(run):
    if not run.span:
        return None
    return idle_ms(run, "score_idle_ms.roundtrip", score_parts(run.span),
                   lambda name: name.startswith("score."))
