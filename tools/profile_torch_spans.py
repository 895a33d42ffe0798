"""Where a benchmark cell's frames spend their time, by the program's own
spans (lajolla_tpu_torch.utils.profiling) on one CUDA GPU.

usage, from the repository root:
    python3 tools/profile_torch_spans.py --workload cbox.final-512
        [--seed N] [--seconds S] [--block K] [--out PATH]

The run does what benchmark/run.py's `--trace 1` run does (the cell's
scene written by its configuration's kind, `parse_scene`, a warm frame, then
frames one after another with seeds drawn from --seed; frames 1 .. the
cell's `trace_frames` traced by torch.profiler on the device alone), with
the span recorder on from before `kernels.build()`. After the traced
frames it renders for --seconds more, in blocks of --block frames with the
recorder on and off in turns (on, off, off, on, ...), so that the
recorder's cost is read on the same card in one process.

Prints on stderr, and writes as JSON to --out:
- the card's name and power limit;
- set-up by span: scene.parse, scene.compile, scene.upload (their sum is
  `scene_setup_s`), kernels.build;
- the traced stretch: device-idle ms a frame by the innermost open span
  (`idle_in_render_ms`: all of it inside render(); the share of that in
  render's own time outside its child spans), and the longest idle gaps
  named by span;
- the device's time a frame by activity;
- the clocks: each K1 launch span's start against its kernel's, each
  render.film_copy span's start and end against its film's copy, each
  render.film_wait span's end against the end of the work it waited for
  (pairs, and the least and most offset: a kernel or copy should start
  after the span that issues it, the copy end inside its span and K1's
  queued work just before its wait ends, within 50 us);
- the untraced frames with the recorder on: the median ms a frame of every
  span name, whole and self (`film_return_ms` is render.film_copy;
  `bounce_issue_ms` path.bounce's self time; `bounce_wait_ms`
  path.bounce_wait), and the host's frame time;
- the recorder's cost: the median frame with it on against off;
- render.film_copy in parts, on a film of the cell's size, timed alone:
  the pool's route whole (utils/film_return.py), and its parts: the
  division on the device and the copy into the pinned block (issue by the
  host's clock, device time by CUDA events), the wait for them;
- the film's routes (`film_return.FILM_RETURNS`) over the warm frame, the
  traced stretch and the untraced frames: every frame after the first
  should take the pinned block.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _smi():
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi: {e}'


def _med(values):
    return statistics.median(values) if values else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, default=2 ** 31 + 11)
    ap.add_argument('--seconds', type=float, default=30.0)
    ap.add_argument('--block', type=int, default=10)
    ap.add_argument('--out')
    args = ap.parse_args()
    out_path = args.out or os.path.join(
        REPO, 'chiprun_out', f'profile_torch_spans.{args.workload}.json')

    import torch
    from benchmark import check, harness
    from benchmark import spans as S
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: the spans are "
                         "read against the GPU's trace")
    spec = harness.load_cell(args.workload)
    traffic, cell = spec['traffic'], spec['cell']
    dev = torch.device('cuda')
    w, h, spp = traffic['width'], traffic['height'], traffic['spp']
    with tempfile.TemporaryDirectory(prefix='spans_scene_') as tmp:
        xml = spec['kind'].write_scene(tmp, spec['config'], w, h, spp)
        import lajolla_tpu_torch
        from lajolla_tpu_torch import kernels
        from lajolla_tpu_torch.utils import film_return, profiling
        profiling.enable()
        kernels.build()
        scene, options = lajolla_tpu_torch.parse_scene(xml, dev)
    setup = profiling.take()

    def frame(k):
        t0 = time.perf_counter()
        lajolla_tpu_torch.render(scene, options, device=dev,
                                 seed=check.frame_seed(args.seed, k))
        return time.perf_counter() - t0
    routes = [dict(film_return.FILM_RETURNS)]
    frame(-1)                                             # warm
    routes.append(dict(film_return.FILM_RETURNS))
    harness.warm_profiler(torch)
    res = dict(workload=args.workload, device=torch.cuda.get_device_name(),
               smi=_smi(), torch=torch.__version__, seed=args.seed,
               setup_s=profiling.seconds_by_name(setup),
               scene_setup_s=S.setup_s(setup))

    # the traced stretch: frames 1 .. trace_frames, recorder on
    trace_frames = cell['trace_frames']
    stretch = S.SpanStretch(torch, lambda: kernels.LAUNCHES)
    frame(0)
    profiling.take()
    stretch.start()
    traced_ms = [1e3 * frame(k) for k in range(1, 1 + trace_frames)]
    stretch.stop(trace_frames)
    routes.append(dict(film_return.FILM_RETURNS))
    spans = profiling.take()
    device = stretch.device_ns()
    lo, hi = stretch.lo_ns, stretch.hi_ns
    idle = S.idle_by_span(spans, device, lo, hi)
    in_render = sum(v for k, v in idle.items() if k != S.OUTSIDE)
    pairs = S.clock_pairs(spans, device)
    res['traced'] = dict(
        frames=trace_frames, frame_ms=traced_ms,
        wall_ms=1e3 * stretch.wall_s, busy_ms=1e3 * stretch.busy_s(),
        launches=stretch.launches,
        trace_start_minus_lo_ns=stretch.trace_start_ns - lo,
        idle_ms_a_frame={k: v / 1e6 / trace_frames for k, v in
                         sorted(idle.items(), key=lambda kv: -kv[1])},
        idle_in_render_ms=in_render / 1e6 / trace_frames,
        render_self_share_of_idle_in_render=(
            idle.get('render', 0) / in_render if in_render else None),
        gaps=S.gaps(spans, device, hi - lo),
        device_ms_a_frame=[[n, 1e3 * v / trace_frames] for n, v in
                           stretch.breakdown()['device_ops']],
        clock={k: dict(pairs=len(v), min_us=min(v) / 1e3,
                       max_us=max(v) / 1e3) for k, v in pairs.items()})

    # untraced frames, the recorder on and off in blocks (ABBA)
    times = {True: [], False: []}
    blocks = []
    k, b, t_end = 1 + trace_frames, 0, time.perf_counter() + args.seconds
    while time.perf_counter() < t_end or b % 2:
        on = (b % 4) in (0, 3)
        (profiling.enable if on else profiling.disable)()
        got = [1e3 * frame(k + i) for i in range(args.block)]
        k += args.block
        times[on] += got
        blocks.append((on, _med(got)))
        b += 1
    profiling.disable()
    routes.append(dict(film_return.FILM_RETURNS))
    on_spans = profiling.take()
    frames = S.render_frames(on_spans)
    names = sorted({s.name for s in on_spans})
    res['untraced'] = dict(
        frames_on=len(times[True]), frames_off=len(times[False]),
        frame_ms_on=_med(times[True]), frame_ms_off=_med(times[False]),
        on_over_off=_med(times[True]) / _med(times[False]),
        block_medians=blocks,
        span_ms={n: dict(whole=S.median_ms(on_spans, frames, n),
                         own=S.median_ms(on_spans, frames, n, own=True),
                         count=sum(s.name == n for s in on_spans) /
                         len(frames))
                 for n in names},
        film_return_ms=S.median_ms(on_spans, frames, 'render.film_copy'),
        bounce_issue_ms=S.median_ms(on_spans, frames, 'path.bounce',
                                    own=True),
        bounce_wait_ms=S.median_ms(on_spans, frames, 'path.bounce_wait'))

    res['film_returns'] = {
        part: {k: b[k] - a[k] for k in a} for part, a, b in zip(
            ('warm', 'frame 0 and traced', 'untraced'), routes, routes[1:])}
    res['film_copy_parts_ms'] = _film_copy_parts(torch, film_return, dev,
                                                 (h, w, 3), spp)

    os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
    with open(out_path, 'w') as f:
        json.dump(res, f, indent=1)
    _report(res)
    return 0


def _film_copy_parts(torch, film_return, dev, shape, spp, reps=20):
    """Medians of `reps` returns of a film of `shape` (h, w, 3) of ones, laid
    out as K1's and K8's are (a (3, h*w) sum seen as (h, w, 3)), through a
    pool of its own, each after a synchronise: the whole return by the
    host's clock, then its parts (the division's and the copy's issue, the
    wait for both; their device times by CUDA events)."""
    h, w, _ = shape
    pool = film_return.FilmPool()
    film = torch.ones((3, h * w), device=dev).T.reshape(shape)
    whole = []
    for _ in range(reps):
        film.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool.return_film(film, spp)
        whole.append(1e3 * (time.perf_counter() - t0))
    tensor, _ = pool.blocks[0]
    divisor = pool._divisor(film, spp)
    parts = {k: [] for k in ('div_issue', 'copy_issue', 'wait',
                             'div_device', 'copy_device')}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        film.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        film.div_(divisor)
        ev[1].record()
        t1 = time.perf_counter()
        tensor.copy_(film, non_blocking=True)
        ev[2].record()
        t2 = time.perf_counter()
        ev[2].synchronize()
        t3 = time.perf_counter()
        for k, v in (('div_issue', t1 - t0), ('copy_issue', t2 - t1),
                     ('wait', t3 - t2)):
            parts[k].append(1e3 * v)
        parts['div_device'].append(ev[0].elapsed_time(ev[1]))
        parts['copy_device'].append(ev[1].elapsed_time(ev[2]))
    return dict(whole=_med(whole), **{k: _med(v) for k, v in parts.items()})


def _report(res):
    p = lambda *a: print(*a, file=sys.stderr)
    tr, un = res['traced'], res['untraced']
    p(f"== {res['workload']} on {res['smi']} (torch {res['torch']})")
    p(f"set-up s: {json.dumps(res['setup_s'])}; scene_setup_s "
      f"{res['scene_setup_s']!r}")
    p(f"traced: {tr['frames']} frames, {tr['wall_ms'] / tr['frames']!r} ms "
      f"a frame, busy {tr['busy_ms'] / tr['frames']!r} ms a frame; "
      f"launches {tr['launches']}")
    p("device-idle ms a frame by the innermost open span (traced stretch):")
    for k, v in tr['idle_ms_a_frame'].items():
        p(f"  {k:<28} {v!r}")
    p(f"idle_in_render_ms {tr['idle_in_render_ms']!r}; render's own time "
      f"holds {tr['render_self_share_of_idle_in_render']!r} of it")
    p("device ms a frame by activity (traced stretch):")
    for name, ms in tr['device_ms_a_frame']:
        p(f"  {ms:10.4f} ms  {name[:100]}")
    p("longest idle gaps:")
    for name, secs in tr['gaps']:
        p(f"  {1e3 * secs:10.4f} ms  {name[:120]}")
    p(f"clocks (trace start - stretch start {tr['trace_start_minus_lo_ns']}"
      f" ns): {json.dumps(tr['clock'])}")
    p(f"untraced: recorder on {un['frames_on']} frames, median "
      f"{un['frame_ms_on']!r} ms; off {un['frames_off']} frames, median "
      f"{un['frame_ms_off']!r} ms; on / off {un['on_over_off']!r}")
    p("span ms a frame, median over the untraced frames with the recorder "
      "on (whole, own, spans a frame):")
    for k, v in un['span_ms'].items():
        p(f"  {k:<20} {v['whole']!r:>22} {v['own']!r:>22} {v['count']!r}")
    p(f"render.film_copy in parts (median of 20, synchronised first): "
      f"{json.dumps(res['film_copy_parts_ms'])}")
    p(f"film returns by route: {json.dumps(res['film_returns'])}")
    p(f"film_return_ms {un['film_return_ms']!r}; bounce_issue_ms "
      f"{un['bounce_issue_ms']!r}; bounce_wait_ms {un['bounce_wait_ms']!r}")


if __name__ == '__main__':
    sys.exit(main())
