"""Scene kinds. A configuration file names its kind (`"kind": "path_diffuse"`),
and benchmark/kinds/<kind>.py is the one place where the harness learns how to
write that scene for the program and how to trace its reference. A kind module
exposes:

- write_scene(directory, config, width, height, spp): writes the scene the
  program parses into `directory` and returns the XML's path;
- build(config, width, height, device): the reference scene, worked out from
  the configuration alone;
- film_pixels(ref, seed, pixels, spp, chunk, rounding=None, stats=None): the
  (P, 3) tensor of the sums over samples 0 .. spp of the film's pixels
  `pixels` in the frame with render seed `seed`, traced `chunk` samples at a
  time; `rounding`, where given, is applied to the path state after each step
  (the control), and `stats`, a dict, gets the reference's work counts;
- rounded(ref, rounding): the reference scene with its float tables rounded
  (the control).

A configuration of a new kind is a new module here with its own reference
modules: no file of the harness is edited.
"""

import importlib
import re


def load(config):
    """The kind module of `config` (a configuration file's object)."""
    kind = config.get('kind')
    module = f'{__name__}.{kind}'
    if isinstance(kind, str) and re.fullmatch(r'[A-Za-z_]\w*', kind):
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    from benchmark.harness import BenchError
    raise BenchError(f"configuration {config.get('name')!r} is of kind "
                     f"{kind!r}, and there is no module {module}")
