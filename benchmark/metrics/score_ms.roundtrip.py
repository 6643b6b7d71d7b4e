"""score_ms.roundtrip: the t-ops scores, host ms a round trip: from each
traced round trip's synchronized reconstruction to the return of the
program's PSNR, SSIM and LPIPS (evaluation/metrics.py, evaluation/
lpips.py), whose host reads synchronize the card at least five times a
trip, over the round trips. Moves roundtrip_s."""


def read(run):
    span = run.span
    if not span or span["units"] < 1 or "score_s" not in span:
        return None
    return 1e3 * span["score_s"]
