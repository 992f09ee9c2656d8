"""Image-service load test (the counterpart of the repository's
tools/load_test.py, with a stdlib client).

Parity with reference src/main/tests/test_image_pipeline.py:15-92: hammer
a running /upscale/image endpoint with a directory of images from a
thread pool over several rounds, reporting ok/err/cache-hit counts,
requests per second and latency percentiles.

    python -m sharkshark_tpu_torch.tools.load_test \\
        --url http://127.0.0.1:8086/upscale/image --images ./samples \\
        --workers 64 --rounds 5 [--requests-per-round 256] [--unique]

`run()` is the same test as a function, over encoded images in memory:
it returns the counts and rates of all rounds together, with each
round's own.  Without `--unique` the rounds draw from the images with
repeats, so behind a cache all but each image's first request are hits;
with it no image is sent twice in the whole run (each round takes
min(requests per round, images // rounds) images not sent before), so
every request is a miss that reaches the model, as long as the images'
bytes differ and the cache does not already hold them.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor

from ..image_server.http_util import post_file

__all__ = ["one_request", "run", "main"]


def one_request(url: str, data: bytes) -> tuple[str, float]:
    """('ok' | 'hit' | 'err', seconds) of one upload with return_type=url."""
    t0 = time.perf_counter()
    try:
        status, body = post_file(url, data, params={"return_type": "url"}, timeout=120)
        reply = json.loads(body) if status == 200 else {}
    except (OSError, http.client.HTTPException, ValueError):  # unreachable, timed out, cut off, not JSON
        reply = {}
    if reply.get("result") != "ok":
        return "err", time.perf_counter() - t0
    return ("hit" if reply.get("cache") == "hit" else "ok"), time.perf_counter() - t0


def _summary(pairs: list[tuple[str, float]], seconds: float) -> dict:
    results = [s for s, _ in pairs]
    lats = sorted(t for _, t in pairs)
    n = len(results)
    hit = results.count("hit")
    ok = results.count("ok") + hit
    return {
        "requests": n, "ok": ok, "err": results.count("err"), "hit": hit,
        "seconds": seconds, "rps": n / seconds,
        "hit_share": hit / max(ok, 1),
        "p50_s": lats[n // 2], "p99_s": lats[min(n - 1, int(n * 0.99))],
    }


def run(url: str, images: list[bytes], workers: int = 64, rounds: int = 5,
        requests_per_round: int = 256, unique: bool = False) -> dict:
    """`rounds` rounds of `requests_per_round` uploads of the encoded
    `images` from `workers` threads (with `unique`, no image twice in the
    run: min(requests_per_round, len(images) // rounds) a round).
    Returns the summary of all rounds together (requests, ok, err, hit
    counts; rps; hit_share of the ok ones; p50_s, p99_s latency) with
    each round's under 'rounds'."""
    if not images:
        raise ValueError("load_test.run: no images")
    if unique:
        per_round = min(requests_per_round, len(images) // rounds)
        if per_round == 0:
            raise ValueError(f"load_test.run: {len(images)} images are too few for {rounds} rounds of unique uploads")
        fresh = random.sample(images, per_round * rounds)
    all_pairs, per_round_res, total_s = [], [], 0.0
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for r in range(rounds):
            if unique:
                batch = fresh[r * per_round:(r + 1) * per_round]
            else:
                batch = [random.choice(images) for _ in range(requests_per_round)]
            t0 = time.perf_counter()
            pairs = list(pool.map(lambda b: one_request(url, b), batch))
            dt = time.perf_counter() - t0
            per_round_res.append(_summary(pairs, dt))
            all_pairs += pairs
            total_s += dt
    return {**_summary(all_pairs, total_s), "rounds": per_round_res}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sharkshark_tpu_torch.tools.load_test")
    p.add_argument("--url", default="http://127.0.0.1:8086/upscale/image")
    p.add_argument("--images", required=True)
    p.add_argument("--workers", type=int, default=64)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--requests-per-round", type=int, default=256)
    p.add_argument("--unique", action="store_true",
                   help="no image is sent twice in the run (every request "
                        "is a cache miss that pays the real model); each "
                        "round sends min(requests per round, images // rounds)")
    args = p.parse_args(argv)

    images = []
    for f in sorted(os.listdir(args.images)):
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
            with open(os.path.join(args.images, f), "rb") as fh:
                images.append(fh.read())
    if not images:
        raise SystemExit(f"no images under {args.images}")
    res = run(args.url, images, args.workers, args.rounds, args.requests_per_round, args.unique)
    for i, r in enumerate(res["rounds"]):
        print(
            f"round {i}: rps={r['rps']:.1f} ok_rate={r['ok'] / r['requests']:.3f} "
            f"err_rate={r['err'] / r['requests']:.3f} cache_rate={r['hit_share']:.3f} "
            f"p50={r['p50_s']:.2f}s p99={r['p99_s']:.2f}s"
        )


if __name__ == "__main__":
    main()
