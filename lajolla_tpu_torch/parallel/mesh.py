"""Multi-GPU rendering: sample-axis data parallelism over torch.distributed.

Port of lajolla_tpu/parallel/mesh.py. lajolla_tpu runs one SPMD program,
a `shard_map` over a mesh of chips that each render the whole film with a
disjoint range of sample indices, and reduces the film with one `psum`.
Here every rank is a process with a GPU of its own (`torchrun
--nproc_per_node=R`, or parallel/spawn.py), and the group is a
torch.distributed process group:

- rank r renders samples r·spp_pc .. (r+1)·spp_pc of every pixel, with
  spp_pc = ceil(spp / R), through the single-device drivers
  (path.render_path_samples, volpath.render_volpath_samples), so it
  launches K1, K2, K8, K9 and the general engines wherever render() does;
- one all_reduce (SUM) of the rank's film sum on its device takes psum's
  place, and the film is divided by spp_pc·R, the rounding up included,
  as lajolla_tpu divides it.

Work items are keyed on (sample, pixel) with a stride that depends only on
the film and the lane pool (path._schedule), so the R ranks draw exactly
the random numbers of one render of spp_pc·R samples: the sharded film is
that render's film up to the order of the float sums. The aux integrators
have no sample axis; they split the film's rows, ceil(h / R) a rank, and
all_gather the equal blocks, dropping the padding rows.

The collectives run on the film's device, with the group's backend: NCCL
for CUDA tensors (one process per GPU; NCCL refuses two ranks on one GPU),
gloo for CPU tensors (gloo also takes CUDA tensors, staged through the
host). Nothing here switches backends or moves a film to another device:
a group that cannot take the film's device raises.
"""

import os

import torch
import torch.distributed as dist

from lajolla_tpu_torch.render import _AUX


def default_group(device='cuda'):
    """The default process group, initialised on the first call from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    with NCCL for device 'cuda' and gloo for 'cpu'. For 'cuda' the rank's
    GPU, cuda:LOCAL_RANK, becomes the current device, so that 'cuda' names
    it in parse_scene and render(). The counterpart of lajolla_tpu's
    default_mesh."""
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', '0')))
    if not dist.is_initialized():
        dist.init_process_group('nccl' if device.type == 'cuda' else 'gloo')
    return dist.group.WORLD


def _group(scene, group):
    return default_group(scene.cam_to_world.device.type) if group is None \
        else group


def _samples(options, group):
    """(first sample, samples a rank, ranks) of this rank's range."""
    ranks = dist.get_world_size(group)
    spp_pc = -(-options.samples_per_pixel // ranks)
    return dist.get_rank(group) * spp_pc, spp_pc, ranks


def _sum_film(driver, scene, options, seed, group):
    group = _group(scene, group)
    s0, spp_pc, ranks = _samples(options, group)
    film = driver(scene, options, seed, s0, s0 + spp_pc).contiguous()
    dist.all_reduce(film, group=group)
    return film / (spp_pc * ranks)


def render_path_sharded(scene, options, seed=0, group=None):
    """Distributed path render → the (h, w, 3) float32 film on the scene's
    device, the same on every rank of `group` (default: default_group()).
    spp is split evenly across the ranks (rounded up)."""
    from lajolla_tpu_torch.integrators.path import render_path_samples
    return _sum_film(render_path_samples, scene, options, seed, group)


def render_volpath_sharded(scene, options, seed=0, group=None):
    """Distributed volumetric path render, each rank's range routed as
    render_volpath routes a render: K9 for the scenes of _use_grid_kernel,
    K8 for those of _use_vol_kernel, else the general engines (and
    versions 1 and 2 their own block). lajolla_tpu's sharded volpath runs
    the general engine only."""
    from lajolla_tpu_torch.integrators.volpath import render_volpath_samples
    return _sum_film(render_volpath_samples, scene, options, seed, group)


def render_volpath_simple_sharded(scene, options, seed=0, group=None):
    """Distributed volpath versions 1 and 2 (the single-bounce
    estimators, vol_path_tracing.h:6-147): _render_volpath_simple_block
    from each rank's first sample."""
    if options.vol_path_version not in (1, 2):
        raise ValueError(f"volpath version {options.vol_path_version} is "
                         "not version 1 or 2")
    return render_volpath_sharded(scene, options, seed, group)


def render_aux_sharded(scene, options, group=None):
    """Distributed aux integrators: ceil(h / R) pixel rows a rank (one
    pixel-centre ray each, render.cpp:12-69), gathered and cropped to the
    film; ranks past the last row compute padding rows that are dropped."""
    from lajolla_tpu_torch.integrators.aux import render_aux_rows
    group = _group(scene, group)
    ranks = dist.get_world_size(group)
    h = scene.meta.height
    rows = -(-h // ranks)
    block = render_aux_rows(scene, options, dist.get_rank(group) * rows,
                            rows).contiguous()
    parts = [torch.empty_like(block) for _ in range(ranks)]
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts)[:h]


class _AllReduceSum(torch.autograd.Function):
    """all_reduce (SUM) over `group` in the forward pass. Its backward
    passes the cotangent through unchanged: every rank holds the same
    loss of the reduced film, so each rank's cotangent is already the
    whole film's, and an all-reduce there would count it R times; each
    rank's parameters then hold their share of the gradient, which
    allreduce_grads sums. Its jvp all-reduces the tangent, so forward
    mode gives the whole derivative on every rank."""

    @staticmethod
    def forward(x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def jvp(ctx, t, _):
        t = t.contiguous().clone()
        dist.all_reduce(t, group=ctx.group)
        return t


def render_diff_sharded(scene, options, seed=0, group=None, depth=6):
    """Distributed DIFFERENTIABLE render (integrators/diffpath.py): rank r
    runs render_diff(spp = spp_pc, s0 = r·spp_pc), and the (h, w, 3) film
    mean is the mean of the ranks' films, the same on every rank. Its
    samples are those of render_diff at spp_pc·R samples, so primal and
    gradients equal the one-process render's at equal total spp.

    Reverse mode: after `loss.backward()` each rank's parameters hold only
    the gradient of its own samples; call allreduce_grads(params, group)
    once, as DDP all-reduces after backward(), and every rank holds the
    whole gradient (lajolla_tpu's jax.grad does this through the
    transpose of psum). Forward mode (diffpath.grad_fwd) needs no extra
    step: the tangent is all-reduced with the film."""
    from lajolla_tpu_torch.integrators.diffpath import render_diff
    group = _group(scene, group)
    s0, spp_pc, ranks = _samples(options, group)
    img = render_diff(scene, options, seed, spp=spp_pc, depth=depth, s0=s0)
    return _AllReduceSum.apply(img, group) / ranks


def allreduce_grads(params, group=None):
    """Sum each parameter's `.grad` over the ranks of `group` in place,
    once after backward() of a loss of a sharded differentiable render;
    parameters without a gradient are skipped in the same order on every
    rank."""
    group = dist.group.WORLD if group is None else group
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def render_sharded(scene, options, seed=0, group=None):
    """Integrator-dispatching distributed render → the (h, w, 3) float32
    film on the scene's device, the same on every rank: the integrators of
    render() (render.cpp:71-149 parallelizes every integrator through one
    tile pool)."""
    if options.integrator in _AUX:
        return render_aux_sharded(scene, options, group)
    if options.integrator == 'volpath':
        if options.vol_path_version in (1, 2):
            return render_volpath_simple_sharded(scene, options, seed, group)
        return render_volpath_sharded(scene, options, seed, group)
    if options.integrator != 'path':
        raise ValueError(f"unknown integrator: {options.integrator}")
    return render_path_sharded(scene, options, seed, group)
