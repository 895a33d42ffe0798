"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

A cell (a workload of BENCHMARK.json) names a configuration
(configs/<config>.json: the scene as data, with its `kind`), a traffic mix
(traffic/<traffic>.json: the film and the samples a frame) and has a file
of its own (cells/<workload>.json: how many frames and pixels the check
compares, the limits, the frames a trace covers, the seconds of frames
that warm up before the window, the small film of the CPU tests). The
configuration's kind (kinds/<kind>.py) writes the scene the program parses
and traces its reference; the harness knows no kind.
Per-layer metrics are readers in metrics/<name>.py with their data in
metrics/<name>.json. Everything is found by name: a new cell on existing
configurations, traffic and metrics is data files alone, and a
configuration of a new kind is configs/<name>.json with its `kind`,
kinds/<kind>.py with its own reference modules, traffic/, cells/ and
metrics/ files and BENCHMARK.json entries, with no edit to a file that is
there.

Every cell is a closed loop with one client: frame k renders the whole
film with the render seed check.frame_seed(seed, k), from the call into
the program until the film is a numpy array on the host, and the next
frame starts when it returns. A `--trace 1` run also turns the program's
span recorder on for the whole window and hands its spans to the
per-layer readers (benchmark/spans.py reads them against the trace).
"""

import contextlib
import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

from benchmark import check, kinds, stats
from benchmark.spans import SpanStretch, render_frames

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that no process of a run may hold once the window
# has closed: the JAX package the port was made from, and JAX itself.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lajolla_tpu')
MIB = 1 << 20


class BenchError(RuntimeError):
    """A run that cannot be made or measured: no result line."""


def _load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(workload):
    """The cell `workload` of BENCHMARK.json with its configuration and
    the configuration's kind module, its traffic, its own file and its
    metrics' entries."""
    path = os.path.join(ROOT, 'BENCHMARK.json')
    if not os.path.exists(path):
        raise BenchError(f"no BENCHMARK.json at {ROOT}")
    with open(path) as f:
        bench = json.load(f)
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = {c['name']: c for c in bench['configs']}[w['config']]
    with open(os.path.join(ROOT, cfg_entry['file'])) as f:
        config = json.load(f)

    end_to_end = [m for m in bench['end_to_end']
                  if workload in m.get('workloads', [workload])]
    reported = {m['name'] for m in end_to_end}

    def applies(m):
        """A per-layer metric's `workloads`, or without them every cell
        that reports the end-to-end metric it moves."""
        return (workload in m['workloads'] if 'workloads' in m
                else m['moves'] in reported)
    return dict(workload=w, config=config, kind=kinds.load(config),
                traffic=_load('traffic', f"{w['traffic']}.json"),
                cell=_load('cells', f'{workload}.json'),
                end_to_end=end_to_end,
                per_layer=[m for m in bench['per_layer'] if applies(m)])


def forbidden_modules():
    """The FORBIDDEN top-level names among sys.modules, compared whole."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def metric_reader(name):
    """metrics/<name>.py, loaded by its path: a metric's name may hold a
    dot (`k1_roofline_pct.preview`, the same quantity where it moves
    another end-to-end metric)."""
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'benchmark.metrics.{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name, ctx):
    """metrics/<name>.py's read(ctx, data) with metrics/<name>.json, or
    None where the trace holds nothing to read."""
    return metric_reader(name).read(ctx, _load('metrics', f'{name}.json'))


def _device_kind(torch, device):
    if device.type == 'cuda':
        return dict(platform='gpu', kind=torch.cuda.get_device_name(device))
    return dict(platform='cpu', kind='cpu')


class Window:
    """The frames of the measured window: when each ended and how long
    each took by the host's clock, from the call into the program until
    the film is a numpy array on the host, and the sampled pixels of each
    film."""

    def __init__(self, pixels):
        self.pixels = pixels
        self.ends, self.times, self.kept = [], [], []

    def frame(self, render_frame, seed_k):
        t0 = time.perf_counter()
        img = render_frame(seed_k)
        t1 = time.perf_counter()
        self.ends.append(t1)
        self.times.append(t1 - t0)
        self.kept.append(np.asarray(img, np.float32).reshape(-1, 3)[
            self.pixels].copy())


def run_window(torch, device, render_frame, seed, seconds, pixels,
               trace_frames=0, counters=dict):
    """Frames until `seconds` have passed since the window's start; the
    frame running then finishes and counts. With trace_frames, frames 1 ..
    trace_frames are traced (a SpanStretch), and the window runs at least
    until they are done. `counters()` gives the program's launch counters,
    read at the stretch's ends. Returns (window, start, stretch, peak
    bytes)."""
    win = Window(pixels)
    stretch = SpanStretch(torch, counters) if trace_frames else None
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    k = 0
    while time.perf_counter() - start < seconds or \
            (stretch is not None and stretch.frames == 0):
        if stretch is not None and k == 1:
            stretch.start()
        win.frame(render_frame, check.frame_seed(seed, k))
        k += 1
        if stretch is not None and k == 1 + trace_frames:
            stretch.stop(trace_frames)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    return win, start, stretch, peak


def warm_up(render_frame, seed, seconds):
    """Frames before the window, counted as set-up: one, and more until
    `seconds` have passed (the cell's `warm_seconds`, 0 where it has
    none), each with its own seed. A process's first seconds of HD
    preview frames run two to three times slower on the host (the
    film's return); they are set-up, not the window. Returns the number
    of frames."""
    t0 = time.perf_counter()
    k = 1
    render_frame(check.frame_seed(seed, -k))
    while time.perf_counter() - t0 < seconds:
        k += 1
        render_frame(check.frame_seed(seed, -k))
    return k


def warm_profiler(torch):
    """One empty profile: the profiler's first start (CUPTI's set-up)
    takes seconds, which belong to set-up, not to the window."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device='cuda').add_(1)
        torch.cuda.synchronize()


def _ms(seconds):
    return None if seconds is None else 1e3 * seconds


def run_single(spec, seed, seconds, trace, t_start, device='cuda',
               render_wrap=None):
    """One run of a cell in this process → (result, check lines).
    `render_wrap`, where given, takes the program's render() and returns
    the function the window calls in its place (the tests' planted
    faults)."""
    import torch
    config, traffic, cell = spec['config'], spec['traffic'], spec['cell']
    kind = spec['kind']
    dev = torch.device(device)
    w, h, spp = traffic['width'], traffic['height'], traffic['spp']
    n = w * h
    marks = [('imports', time.perf_counter())]
    with tempfile.TemporaryDirectory(prefix='bench_scene_') as tmp:
        xml = kind.write_scene(tmp, config, w, h, spp)
        import lajolla_tpu_torch
        from lajolla_tpu_torch import kernels
        marks.append(('program import', time.perf_counter()))
        if dev.type == 'cuda':
            kernels.build()
        marks.append(('kernels.build', time.perf_counter()))
        scene, options = lajolla_tpu_torch.parse_scene(xml, dev)
        marks.append(('parse_scene', time.perf_counter()))
    render = lajolla_tpu_torch.render
    if render_wrap is not None:
        render = render_wrap(render)

    def render_frame(seed_k):
        return render(scene, options, device=dev, seed=seed_k)
    warm = warm_up(render_frame, seed, cell.get('warm_seconds', 0))
    marks.append((f'warm-up ({warm} frames)', time.perf_counter()))
    if trace and dev.type == 'cuda':
        warm_profiler(torch)
        marks.append(('profiler', time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    notes = ['setup: ' + ', '.join(
        f'{name} {b - a:.3f} s' for (_, a), (name, b) in
        zip([('start', t_start)] + marks[:-1], marks))]
    pixels = check.sample_pixels(seed, n, cell['check_block_pixels'])
    recorder = contextlib.nullcontext([])
    if trace:
        from lajolla_tpu_torch.utils import profiling
        recorder = profiling.recording()
    with recorder as spans:
        win, start, stretch, peak = run_window(
            torch, dev, render_frame, seed, seconds, pixels,
            cell['trace_frames'] if trace else 0,
            counters=lambda: kernels.LAUNCHES)
    found = forbidden_modules()
    if found:
        raise BenchError(f"modules loaded by the run: {found}")
    del scene, render, render_frame
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    numbers, failed, work, ref = _check(dev, spec, seed, win, pixels)
    device = dict(**_device_kind(torch, dev), count=1,
                  memory_peak_bytes=int(peak))
    if trace:
        frames = render_frames(spans)
        stretch.spans = spans
        values = layer_values(spec, dict(
            stretch=stretch, work=work, ref=ref, width=w, height=h, spp=spp,
            spans=spans, traced_frames=frames[1:1 + stretch.frames],
            untraced_frames=frames[1 + stretch.frames:]))
        device.update(busy_s=stretch.busy_s(), window_s=stretch.window_s())
        rest = win.times[1 + stretch.frames:]
        notes.append(
            f"trace: {stretch.frames} traced frames, "
            f"{_ms(stretch.wall_s / stretch.frames)!r} ms a frame; the "
            f"window's {len(rest)} untraced frames after them, "
            f"{_ms(statistics.median(rest)) if rest else None!r} ms median")
    else:
        values = dict(mpaths_per_s=stats.window_rate(n * spp, win.ends, start),
                      frame_p95_ms=_ms(stats.p95(win.times)),
                      peak_mem_mib=peak / MIB, setup_s=setup_s)
    result, lines = assemble(spec, trace, numbers, failed, len(win.ends),
                             values, device,
                             stretch.breakdown() if trace else None)
    return result, notes + lines


def _check(dev, spec, seed, win, pixels):
    """(numbers compared, frames compared that fail on their own,
    reference work a path, reference scene) of the window's frames drawn
    from the seed."""
    kind, cell = spec['kind'], spec['cell']
    w, h = spec['traffic']['width'], spec['traffic']['height']
    ref = kind.build(spec['config'], w, h, device=dev)
    picked = check.sample_frames(seed, len(win.kept), cell['check_frames'])
    work = {}
    want = check.reference_pixels(
        kind, ref, [check.frame_seed(seed, k) for k in picked], pixels,
        spec['traffic']['spp'], cell['check_chunk'], stats=work)
    got = np.stack([win.kept[k] for k in picked])
    numbers = check.compare(got, want, pixels)
    failed = sum(not check.verdict(check.compare(g[None], r[None], pixels),
                                   cell['limits'])
                 for g, r in zip(got, want))
    paths = len(picked) * len(pixels) * spec['traffic']['spp']
    return numbers, failed, {k: v / paths for k, v in work.items()}, ref


def layer_values(spec, ctx):
    """{name: value} of the cell's per-layer metrics read from ctx."""
    return {m['name']: read_metric(m['name'], ctx) for m in spec['per_layer']}


def assemble(spec, trace, numbers, failed, frames, values, device,
             breakdown):
    """The result line's object and the check lines: the cell's
    end-to-end metrics (trace off) or per-layer ones (trace on) among
    `values`, those that read None left out; `checks` last."""
    limits = spec['cell']['limits']
    correct = check.verdict(numbers, limits) and not failed
    wanted = spec['per_layer'] if trace else spec['end_to_end']
    metrics = {m['name']: dict(value=values[m['name']], unit=m['unit'])
               for m in wanted if values.get(m['name']) is not None}
    result = dict(correct=correct, attempted=frames, failed=failed,
                  metrics=metrics, device=device)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = {k: dict(value=numbers[k], limit=limits[k])
                        for k in check.NUMBERS}
    lines = [f"check {k}: {numbers[k]!r} (limit {limits[k]!r})"
             for k in check.NUMBERS]
    return result, lines
