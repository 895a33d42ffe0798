"""The `path_diffuse` kind: Lambertian quads lit by one area light, under the
`path` integrator (the Cornell box; the port renders it through K1). The
writer is benchmark/scenes.py; the reference works its tables out from the
configuration (reference/tables.py) and traces a frozen plain form of the
path vertex (reference/items.py, reference/path_vertex.py)."""

from benchmark.reference.items import film_pixels, rounded
from benchmark.reference.tables import build
from benchmark.scenes import write_scene

__all__ = ['build', 'film_pixels', 'rounded', 'write_scene']
