"""Where the grid-media films of lajolla_tpu and lajolla_tpu_torch part, on
the CPU: the heterogeneous Cornell box ('hetvol' with a 32x32x16 density
grid, the test fixture) at 64x32 x 1 spp, n = 2048 paths, one whole K9
block, so that every renderer below draws the same random numbers.

usage, from the repository root:
    JAX_PLATFORMS=cpu python3 tools/profile_torch_grid_parity.py

Renders five films:
- jax_k9: lajolla_tpu's `render_fused_grid` in Pallas interpret mode,
  f32 density (GRID_BF16 off);
- jax_engine: lajolla_tpu's `_render_volpath_block` (the event machine);
- jax_engine_op_by_op: the same event machine, one `_advance_event` per
  iteration under `jax.disable_jit()`, so that every primitive runs as
  its own XLA computation and no multiply-add is contracted into an FMA
  (the slow part: ~22 minutes and ~11 GB of host memory);
- k9 and engine: the port's K9 plain form and event machine.
Prints, for each pair, the 95th percentile per-pixel relative difference,
the relative difference of the film means and the number of pixels whose
channels differ by more than 1e-5. Like the tests, and unlike the port,
it imports both packages: it compares them.
"""

import itertools
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GRID = (32, 32, 16)


def op_by_op_engine(js, options, su, n):
    """lajolla_tpu's event machine at 1 spp over n lanes (lane k takes
    item k and no item follows), one vmapped `_advance_event` per
    iteration without jit. Returns the (n, 3) film."""
    import jax
    import jax.numpy as jnp

    import lajolla_tpu.integrators.volpath as JV
    import lajolla_tpu_torch.integrators.volpath as PV
    from lajolla_tpu_torch.bridge import scene_from_jax
    from lajolla_tpu_torch.scene.types import RenderOptions
    from lajolla_tpu_torch.testing import EVENT_STATE_JAX_DTYPES
    import torch

    fresh = PV._fresh_state(scene_from_jax(js),
                            RenderOptions(integrator='volpath'),
                            torch.arange(n), su, True) + (
        torch.zeros(n, dtype=torch.bool),)
    st = [x.numpy().astype(EVENT_STATE_JAX_DTYPES.get(k, x.numpy().dtype))
          for k, x in zip(PV.EVENT_STATE, fresh)]
    step = jax.vmap(lambda *s: JV._advance_event(js, options, s,
                                                 jnp.uint32(su)))
    i_l = PV.EVENT_STATE.index('L')
    film = np.zeros((n, 3), np.float32)
    with jax.disable_jit():
        while not st[-1].all():
            out, died = step(*st)
            st = [np.asarray(x) for x in out]
            died = np.asarray(died)
            keep = died & np.isfinite(st[i_l]).all(1)
            film[keep] += st[i_l][keep]
            st[-1] = st[-1] | died
    return film


def main():
    import torch

    import lajolla_tpu.integrators.volpath as JV
    import lajolla_tpu.integrators.volpath_grid_kernel as JGK
    import lajolla_tpu.scene.compile as JC
    from lajolla_tpu.scene.types import RenderOptions as JOptions
    import lajolla_tpu_torch.integrators.volpath as PV
    import lajolla_tpu_torch.integrators.volpath_grid_kernel as PGK
    import lajolla_tpu_torch.testing as PT
    from lajolla_tpu_torch.bridge import scene_from_jax
    from lajolla_tpu_torch.scene.types import RenderOptions

    torch.set_num_threads(2)
    vol, jvol = RenderOptions(integrator='volpath'), \
        JOptions(integrator='volpath')
    js = JC.compile_scene(PT.cornell_box_builder(
        (64, 32), 1, variant='hetvol', grid_res=GRID))
    ps = scene_from_jax(js)
    n = 64 * 32
    films = {}
    t0 = time.perf_counter()
    JGK.INTERPRET, JGK.GRID_BF16 = True, False
    films['jax_k9'] = np.asarray(JGK.render_fused_grid(js, jvol, 0, 0, 1))
    films['jax_engine'] = np.asarray(
        JV._render_volpath_block(js, jvol, 0, 0, 1, None)[0])
    films['k9'] = PGK.render_fused_grid_plain(ps, vol, 0, 0, 1).numpy()
    films['engine'] = PV._render_volpath_block(ps, vol, 0, 0, 1)[0].numpy()
    print(f"four films in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    films['jax_engine_op_by_op'] = op_by_op_engine(
        js, jvol, PV.stream_root(0), n)
    print(f"op-by-op film in {time.perf_counter() - t0:.1f} s")
    films = {k: v.reshape(-1, 3) for k, v in films.items()}
    for a, b in itertools.combinations(films, 2):
        x, y = films[a], films[b]
        rel = np.abs(x - y) / (y + 1e-3)
        print(f"{a} vs {b}: p95 rel {np.percentile(rel, 95):.3g}, mean rel "
              f"{abs(x.mean() - y.mean()) / y.mean():.4g}, pixels differing "
              f"{int((np.abs(x - y).max(1) > 1e-5).sum())} of {n}")


if __name__ == '__main__':
    main()
