"""Command-line renderer, mirroring the reference executable's interface:
`python -m jet_pbrt_tpu.cli <sceneid> [spp]` (reference: src/main.cc:113-163,
`pbrt.exe sceneid spp`), plus flags the reference hard-codes.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="jet_pbrt_tpu renderer")
    p.add_argument("sceneid", type=int, help="0 = cornell box, 1 = bunny")
    p.add_argument("spp", type=int, nargs="?", default=50,
                   help="samples per pixel (reference default 50)")
    p.add_argument("--size", type=int, default=1024,
                   help="square resolution (reference: 1024)")
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--integrator", default="path",
                   choices=["path", "whitted", "debug"])
    p.add_argument("--sampler", default="random",
                   choices=["random", "stratified", "debug"])
    p.add_argument("--mis", action="store_true",
                   help="enable power-heuristic MIS (reference-divergent)")
    p.add_argument("--format", default="bmp", choices=["bmp", "ppm", "hdr"])
    p.add_argument("--no-clamp", action="store_true",
                   help="keep HDR output (the reference clamps to [0,1])")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--stats", default=None, metavar="PATH",
                   help="write timings, ray counts and image summary as JSON")
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="run on this JAX platform; with gpu and no GPU "
                        "present, exit non-zero (default: JAX's choice)")
    args = p.parse_args(argv)

    import jax
    from .utils.device import describe_devices, enable_compile_cache
    from .utils.log import log_print

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    try:
        dev = describe_devices()
    except RuntimeError as e:
        log_print(f"no {args.platform} device: {e}")
        return 2
    if args.platform and dev["platform"] != args.platform:
        log_print(f"asked for {args.platform}, JAX runs on {dev['platform']}")
        return 2
    log_print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    enable_compile_cache()

    from .scene.scenes import SCENES
    from .models.render import render
    from .models import film as film_mod

    if args.sceneid not in SCENES:
        log_print(f"unknown scene id {args.sceneid}")
        return 1
    if args.size <= 0 or args.spp <= 0:
        log_print("size and spp must be positive")
        return 1

    scene = SCENES[args.sceneid]()
    log_print(f"current scene: {scene.meta.name}")
    stats = {}
    t0 = time.perf_counter()
    img = render(
        scene, args.size, args.size, args.spp, seed=args.seed,
        max_depth=args.max_depth, integrator=args.integrator, mis=args.mis,
        sampler=args.sampler, clamp=not args.no_clamp, stats=stats,
    )
    stats["total_s"] = time.perf_counter() - t0
    msg = (f"render finished in {stats['total_s']:.2f}s: first wave call "
           f"{stats['first_call_s']:.2f}s (compile included), "
           f"{stats['steady_calls']} more calls in {stats['steady_s']:.2f}s")
    if stats.get("rays") and stats["steady_s"] > 0:
        stats["rays_per_s"] = stats["rays"] / stats["steady_s"]
        msg += f", {stats['rays_per_s'] / 1e6:.2f}M estimator rays/s"
    log_print(msg)
    base = args.out or f"{scene.meta.name}_{args.spp}"
    path = film_mod.save(img, base, args.format)
    log_print(f"saved {path}")
    if args.stats:
        stats.update(device=dev, scene=scene.meta.name, image=path,
                     image_finite=bool(np.isfinite(img).all()),
                     image_mean=float(np.mean(img)))
        with open(args.stats, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
