"""Multi-host rendering: process initialization, host-aware meshes, and a
scaling-efficiency harness.

The reference's entire parallel substrate is a single-process thread pool
(reference: src/parallel.cc:59-92); its successor here spans hosts.
Design (SURVEY.md §2.3): the *pixel* axis is sharded across hosts — film
tiles are embarrassingly parallel and the px-sharded film never needs a
cross-host collective — while the *sample* axis stays inside a host so the
film-merge psum and gradient all-reduce stay on the host's own links. Counter-based
per-pixel RNG (ops/rng.py) keys streams by GLOBAL ids, so the image is
identical for any host count.

On a single process (tests, the 8-virtual-device CPU mesh) everything here
degrades gracefully to the local mesh.
"""
from __future__ import annotations

import time

import numpy as np

import jax
from jax.sharding import Mesh


def _distributed_active() -> bool:
    """Whether jax.distributed is already initialized (without touching the
    backend — jax.process_count() would *initialize* the local backend,
    after which distributed init is a silent single-host no-op)."""
    try:
        from jax._src import distributed
        return distributed.global_state.client is not None
    except Exception:
        return False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> int:
    """Bring up jax.distributed for a multi-host run; returns process count.

    MUST run before anything touches the backend (jax.devices(),
    jax.process_count(), any computation) — the CLI calls it first thing.
    Opt-in is explicit: pass a coordinator address (with num_processes and
    process_id), or set JET_MULTIHOST=1 (argument-less auto-config, for
    cluster environments that jax.distributed.initialize() can read
    itself), or export JAX_COORDINATOR_ADDRESS/COORDINATOR_ADDRESS.
    Anything else is a no-op, so single-host runs are unaffected.

    Successor of the reference's thread-pool Start() (src/parallel.cc:59-66)
    at the cross-host level."""
    import os

    opted_in = bool(
        coordinator_address is not None
        or os.environ.get("JET_MULTIHOST") == "1"
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
        or os.environ.get("COORDINATOR_ADDRESS")
    )
    if opted_in and not _distributed_active():
        if coordinator_address is not None:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
        else:
            # argument-less: cluster environments auto-configure
            jax.distributed.initialize()
    return jax.process_count()


def make_multihost_mesh(spp: int | None = None, devices=None) -> Mesh:
    """(px, spp) mesh with px spanning hosts and spp inside each host.

    spp: devices per host on the sample axis (default: all local devices,
    i.e. px == host count). Works unchanged on one host, where it reduces
    to a local mesh."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    n_hosts = max(1, jax.process_count())
    per_host = n // n_hosts
    if spp is None:
        spp = per_host
    assert per_host % spp == 0, (per_host, spp)
    px_local = per_host // spp
    # order devices host-major so the px axis strides across hosts and the
    # spp axis stays within a host
    ordered = sorted(devices.ravel(),
                     key=lambda d: (getattr(d, "process_index", 0), d.id))
    arr = np.asarray(ordered).reshape(n_hosts * px_local, spp)
    return Mesh(arr, ("px", "spp"))


def scaling_report(scene, width: int, height: int, spp: int,
                   device_counts=None, seed: int = 0, max_depth: int = 3,
                   n_reps: int = 2) -> list[dict]:
    """Fixed-size frame rendered on growing device meshes; reports wall time
    and scaling efficiency vs the smallest mesh (strong scaling).

    Runs anywhere: on the 8-virtual-device CPU mesh it validates the
    machinery (virtual devices share one physical CPU, so times there
    measure correctness of the harness, not hardware scaling); on real
    devices it is the BASELINE 'scaling to 2 hosts >= 90%' measurement."""
    from ..models import camera as camera_mod
    from .render import build_sharded_render

    devs = jax.devices()
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8) if c <= len(devs)]
    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, height),
    )
    rows = []
    for c in device_counts:
        mesh = Mesh(np.asarray(devs[:c]).reshape(c, 1), ("px", "spp"))
        fn = build_sharded_render(scene.meta, mesh, width, height, spp,
                                  seed=seed, max_depth=max_depth)
        out = fn(scene.pack, cam)
        jax.block_until_ready(out)  # compile + warmup
        t0 = time.perf_counter()
        for _ in range(n_reps):
            out = fn(scene.pack, cam)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / n_reps
        rows.append({"devices": c, "seconds": dt})
    # device-seconds of the smallest mesh = the "1x" work unit
    base = rows[0]["seconds"] * rows[0]["devices"]
    for r in rows:
        r["speedup"] = rows[0]["seconds"] / r["seconds"]
        r["efficiency"] = base / (r["seconds"] * r["devices"])
    return rows


def format_scaling_table(rows: list[dict]) -> str:
    lines = ["| devices | seconds | speedup | efficiency |",
             "|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['devices']} | {r['seconds']:.3f} | "
            f"{r['speedup']:.2f}x | {100 * r['efficiency']:.0f}% |"
        )
    return "\n".join(lines)
