"""Device-mesh construction for sharded rendering.

The reference's only parallelism is a 16-thread pool over film rows
(reference: src/parallel.cc, src/integrator.cc:53-71). The equivalent
here is a 2-D logical mesh:

  * axis "px"  — data parallelism over pixel blocks (the analogue of the
    reference's FFilmView row strips);
  * axis "spp" — sample parallelism: devices render disjoint sample indices
    of the *same* pixels and psum their film contributions.

Counter-based RNG makes the spp axis trivially correct: any (pixel, sample)
stream is recomputable on any device.
"""
from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(px: int | None = None, spp: int = 1, devices=None) -> Mesh:
    """Build a (px, spp) mesh. Defaults to all devices on the px axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if px is None:
        assert n % spp == 0, (n, spp)
        px = n // spp
    assert px * spp == n, f"mesh {px}x{spp} != {n} devices"
    import numpy as np

    return Mesh(np.array(devices).reshape(px, spp), ("px", "spp"))
