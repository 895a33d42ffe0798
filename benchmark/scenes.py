"""The `path_diffuse` kind's writer (kinds/path_diffuse.py): a
configuration's scene as Mitsuba XML, the files the program parses:
cbox.xml and one OBJ a shape (its quads, four vertices each, as
`f a b c d` lines). The writer follows the port's own Cornell-box writer
line for line, so the program parses what its tests parse; the reference
(reference/tables.py) reads the configuration itself."""

import os

SCENE_FILE = 'cbox.xml'


def _rgb(v):
    return ', '.join(repr(float(c)) for c in v)


def _bsdf_xml(name, mat):
    if mat['type'] == 'diffuse':
        return [f'  <bsdf type="diffuse" id="{name}">',
                f'    <rgb name="reflectance" value="{_rgb(mat["reflectance"])}"/>',
                '  </bsdf>']
    raise ValueError(f"the writer has no material type {mat['type']!r}")


def write_scene(directory, config, width, height, spp):
    """Write `config`'s scene at a width x height film and spp samples a
    pixel into `directory`; returns the XML's path."""
    os.makedirs(directory, exist_ok=True)
    cam = config['camera']
    if cam.get('filter', 'box') != 'box':
        raise ValueError("the writer takes the box filter")
    o, t, u = (_rgb(cam[k]) for k in ('origin', 'target', 'up'))
    lines = [
        '<?xml version="1.0" encoding="utf-8"?>',
        '<scene version="0.5.0">',
        f'  <integrator type="{config["integrator"]}"/>',
        '  <sensor type="perspective">',
        f'    <float name="fov" value="{float(cam["fov"])!r}"/>',
        '    <transform name="toWorld">',
        f'      <lookat origin="{o}" target="{t}" up="{u}"/>',
        '    </transform>',
        '    <sampler type="independent">',
        f'      <integer name="sampleCount" value="{spp}"/>',
        '    </sampler>',
        '    <film type="hdrfilm">',
        f'      <integer name="width" value="{width}"/>',
        f'      <integer name="height" value="{height}"/>',
        '      <rfilter type="box"/>',
        '    </film>',
        '  </sensor>',
    ]
    for name, mat in config['materials'].items():
        lines += _bsdf_xml(name, mat)
    for shape in config['shapes']:
        name = shape['name']
        with open(os.path.join(directory, f'{name}.obj'), 'w') as f:
            for quad in shape['quads']:
                for p in quad:
                    f.write('v ' + ' '.join(repr(float(x)) for x in p) + '\n')
            for k in range(len(shape['quads'])):
                f.write('f ' + ' '.join(str(i) for i in
                                        range(4 * k + 1, 4 * k + 5)) + '\n')
        lines += ['  <shape type="obj">',
                  f'    <string name="filename" value="{name}.obj"/>']
        lines += [f'    <ref id="{shape["material"]}"/>']
        if 'emitter' in shape:
            lines += ['    <emitter type="area">',
                      f'      <rgb name="radiance" value="{_rgb(shape["emitter"])}"/>',
                      '    </emitter>']
        lines += ['  </shape>']
    lines += ['</scene>', '']
    path = os.path.join(directory, SCENE_FILE)
    with open(path, 'w') as f:
        f.write('\n'.join(lines))
    return path
