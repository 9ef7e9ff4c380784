"""SPMD sharded rendering over a (px, spp) device mesh.

The whole frame is computed by one shard_map program: every device renders
its pixel block for its slice of sample indices, accumulates a local film,
and the spp axis is reduced with `lax.psum` — film-tile merging as a
device collective instead of the reference's shared-memory FFilmView writes
(reference: src/integrator.cc:53-71, src/film.h:103-136). The scene pack and
camera are replicated (in_specs P()); the film comes back sharded over px
(out_specs P("px")), so on real hardware the gather happens only if the host
materializes the image.

shard_map is differentiable: gradient-based fitting simply wraps
`build_sharded_render` in jax.grad, and XLA inserts the corresponding
psum for the replicated parameter gradients (the gradient all-reduce of
SURVEY.md §2.3).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
from jax import shard_map

from ..models import camera as camera_mod
from ..models import integrators
from ..ops import rng


def build_sharded_render(meta, mesh, width: int, height: int, spp: int,
                         seed: int = 0, max_depth: int = 5, mis: bool = False,
                         sampler: str = "random", sort_rays: bool = False):
    """Returns fn(pack, cam) -> [H*W, 3] flat film (averaged over spp),
    jit-compiled over `mesh`.

    Requires H*W divisible by mesh.shape['px'] and spp divisible by
    mesh.shape['spp'] (pad spp up at the call site if needed).

    RNG streams are keyed by (seed, global sample index, global pixel id)
    only — never by the shard layout — so an (8,1) mesh, a (4,2) mesh and
    the single-chip renderer all produce the same image (the spp-axis psum
    can reassociate the per-pixel sum, so equality is to float tolerance,
    not bitwise). The full sampler family (random/stratified/debug) is
    available, matching the single-chip API.
    """
    n_px_shards = mesh.shape["px"]
    n_spp_shards = mesh.shape["spp"]
    n_pixels = width * height
    assert n_pixels % n_px_shards == 0, (n_pixels, n_px_shards)
    assert spp % n_spp_shards == 0, (spp, n_spp_shards)
    local_pixels = n_pixels // n_px_shards
    local_spp = spp // n_spp_shards

    def shard_fn(pack, cam):
        ip = lax.axis_index("px")
        isp = lax.axis_index("spp")
        ids = ip * local_pixels + jnp.arange(local_pixels, dtype=jnp.int32)

        def one_wave(s):
            # global sample index: every (pixel, sample) stream is unique
            s_global = isp * local_spp + s
            keys = rng.lane_keys(seed, s_global, ids)
            jitter = rng.camera_jitter(keys, sampler=sampler,
                                       sample_index=s_global, spp=spp)
            x = (ids % width).astype(jnp.float32) + jitter[:, 0]
            y = (ids // width).astype(jnp.float32) + jitter[:, 1]
            o, d = camera_mod.generate_rays(cam, jnp.stack([x, y], axis=-1))
            if sampler == "debug":
                u = rng.debug_path_uniforms(local_pixels, max_depth,
                                            meta.n_lights)
            else:
                u = keys
            return integrators.li_path(meta, pack, o, d, u, max_depth,
                                       mis=mis, sort_rays=sort_rays)

        def step(film, s):
            return film + one_wave(s), None

        film0 = lax.pcast(
            jnp.zeros((local_pixels, 3), jnp.float32), ("px", "spp"),
            to="varying",
        )
        film, _ = lax.scan(step, film0, jnp.arange(local_spp))
        # merge sample-parallel partial films
        film = lax.psum(film, "spp")
        return film / jnp.float32(spp)

    fn = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P("px"),
    )
    return jax.jit(fn)


def render_sharded(scene, width: int, height: int, spp: int, mesh,
                   seed: int = 0, max_depth: int = 5, mis: bool = False,
                   clamp: bool = True, sampler: str = "random"):
    """Convenience wrapper: full sharded frame as a [H,W,3] array."""
    import numpy as np

    cam = camera_mod.make_camera(
        scene.camera.lookfrom, scene.camera.front, scene.camera.vup,
        scene.camera.vfov, (width, height),
    )
    fn = build_sharded_render(scene.meta, mesh, width, height, spp,
                              seed=seed, max_depth=max_depth, mis=mis,
                              sampler=sampler)
    flat = fn(scene.pack, cam)
    img = np.asarray(flat).reshape(height, width, 3)
    if clamp:
        img = np.clip(img, 0.0, 1.0)
    return img
