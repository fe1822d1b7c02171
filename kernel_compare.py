#!/usr/bin/env python3
"""Time the port's kernels against another checkout's, in turns, on one
CUDA card.

    git archive <commit> autolabel_tpu_torch | tar -x -C build/parent
    python3 kernel_compare.py [--parent build/parent] [--rounds 4]

Both packages are imported side by side, each as a module tree of its own
that builds its kernels into a build directory beside itself, and every
kernel of the main path is called through each package's public wrapper
on the same inputs: K1 at TPU_GRID (wide rows) and at the reference preset
(narrow rows), K2, K3f, K3b, K4f and K4b at chip_smoke.py's shapes, K2
also on the (g, x) of a step of chip_smoke.py's training slice, and K5
and K2s on the inputs a flagship step hands them (chip_smoke.py's
flagship 'xla' leg after 200 steps; K2s fed one (sel, coef, count), this
tree's K5's), and K1s in its four instantiations (simplex or trilinear
atoms; the training form, bf16 out with the atoms written, or the eval
form, fp32 out) on the (table, x) a flagship step hands it (N = 131,072)
and on the last step's of a short run of the train CLI (README's command,
the ray-ordered samples of N = 524,288 a step), and K6 (training form,
rows written) and K7 on the last step's (table, x) of short runs of the
CLI's stochastic estimators: Run C (--sampled-backward 0: the TPU grid's
simplex encode of 2 draws) and Run D (--grid-preset reference
--stochastic-exact-levels 4: 16 x 2^19 x 2, trilinear, narrow rows), K7
fed this tree's K6 rows. Each kernel's old and new outputs are compared
(largest absolute difference; 0 means bit-equal; for K5 whether the
selections, count, points and coefs, are bit-equal; for K7 the worst
element's share of hashgrid_cuda.stochastic_backward_tolerance, at most
1), then both are timed by CUDA events, old, new, new, old, ... for
--rounds rounds, and by torch.profiler's device time a call (all of a
call's kernels and memsets; events carry a call's host work where it
exceeds its device time); K7 with one index_add_ of the pre-weighted
drawn rows timed in the same rounds, its library yardstick. Then, for this
tree alone, K6's parts on the same inputs (the draws with their rows
written, the gathers and blend, the stores, each launched alone; on Run D
also the levels a narrow thread walks: 1, levels slowest, and 4, a
32-byte sector a point, beside the library's choice of all 16), K7's
scatter of each level alone and the distinct rows a tile of K7's points
(a block's on wide rows, a warp's on narrow rows) names per level. --only takes a regular expression of the cases to run (e.g.
'K6|K7'). Prints one line per kernel and writes
chiprun_out/kernel_compare.json.
"""
import argparse
import importlib
import json
import os
import re
import sys
import types

from chip_smoke import _cuda_ms, _gpu_line, _kernel_ms, k7_yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = 'autolabel_tpu_torch'
MODULES = ('ops._kernels', 'ops.encoders', 'ops.hashgrid_cuda',
           'ops.heads_cuda', 'ops.mlp')


def _load(root):
    """The package under root as a module tree of its own: the modules of
    MODULES by their last name. sys.modules is left as it was."""
    def ours(name):
        return name == PKG or name.startswith(PKG + '.')
    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, root)
    try:
        mods = {m.split('.')[-1].lstrip('_'): importlib.import_module(
            f'{PKG}.{m}') for m in MODULES}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return types.SimpleNamespace(**mods)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [] if out is None else [out]


def _max_diff(a, b):
    return max((float((x - y).abs().max()) if x.numel() else 0.0)
               for x, y in zip(_flat(a), _flat(b)))


def _step_samples(seed, steps=40):
    """The (g, x) that a training step's backward hands K2, recorded from
    chip_smoke.py's training slice (this tree's package) after `steps`
    steps: the main path's own ray-ordered traffic."""
    import torch
    from chip_smoke import _record_k2_inputs, _train_slice
    trainer, loader, _ = _train_slice(torch.device('cuda'), seed)
    trainer.train_iterations(loader, steps)
    return _record_k2_inputs(trainer, loader)


def _flagship_samples(seed, steps=200):
    """What a flagship step hands K5 (g, u, k) and K2s (the atoms and rows),
    recorded from chip_smoke.py's flagship 'xla' leg (this tree's package)
    after `steps` steps, with the grid config and this tree's K5 selection
    (sel, coef, count)."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from chip_smoke import (TRAIN_CHUNK, _flagship_options, _model_config,
                            _record_flagship_inputs, _train_slice)
    trainer, loader, _ = _train_slice(torch.device('cuda'), seed,
                                      _model_config('simplex', 'xla'),
                                      _flagship_options(), 'compare')
    for _ in range(steps // TRAIN_CHUNK):
        trainer.train_iterations(loader, TRAIN_CHUNK)
    rec = _record_flagship_inputs(trainer, loader, hashgrid_cuda)
    g, u, k = rec['select']
    return dict(g=g, u=u, k=k, atoms=rec['scatter'], encode=rec['atoms'],
                grid=trainer.field.config.grid_config,
                selection=hashgrid_cuda.select_points(g, u, k))


def _cli_samples(iters=30):
    """The (table, x) the train CLI's last step hands K1s (README's command,
    4,096 rays x 128 samples, this tree's package) after `iters` steps on
    the sphere scene chip_smoke.py's phase 10 writes, with its grid."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import CLI_SCENE, WORK_DIR
    root = os.path.join(WORK_DIR, 'compare_cli')
    scene = os.path.join(root, 'sphere')
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    rec, atoms = {}, hashgrid_cuda._atoms_call

    def rec_atoms(table, x, config, interp, out_dtype, with_atoms):
        if with_atoms:
            rec['atoms'] = (table.detach().clone(), x.clone())
        return atoms(table, x, config, interp, out_dtype, with_atoms)

    hashgrid_cuda._atoms_call = rec_atoms
    try:
        run = cli.main([scene, '--proposal', '--factor-train', '1',
                        '--iters', str(iters),
                        '--workspace', os.path.join(root, 'ws')])
    finally:
        hashgrid_cuda._atoms_call = atoms
    return rec['atoms'], run.trainer.field.config.grid_config


# The CLI's stochastic estimators (chip_smoke.py's phase 11 runs C and D).
STOCHASTIC_RUNS = {'C': ['--sampled-backward', '0'],
                   'D': ['--grid-preset', 'reference',
                         '--stochastic-exact-levels', '4']}


def _stochastic_samples(iters=30):
    """{run: (table, x, config, interp, n_samples, plan)}: what the last of
    `iters` steps of each of STOCHASTIC_RUNS hands K6 (this tree's
    package), on the sphere scene of chip_smoke.py's phase 10."""
    from autolabel_tpu_torch.ops import hashgrid_cuda
    from autolabel_tpu_torch.train import __main__ as cli
    from autolabel_tpu_torch.utils import fixtures
    from chip_smoke import CLI_SCENE, WORK_DIR
    root = os.path.join(WORK_DIR, 'compare_stochastic')
    scene = os.path.join(root, 'sphere')
    fixtures.make_synthetic_scene(scene, **CLI_SCENE)
    out, call = {}, hashgrid_cuda._stochastic_call
    for run, flags in STOCHASTIC_RUNS.items():
        rec = {}

        def rec_call(table, x, u, config, interp, n_samples, plan, rows,
                     **kw):
            if rows:
                rec['last'] = (table.detach().clone(), x.clone(), config,
                               interp, n_samples, plan)
            return call(table, x, u, config, interp, n_samples, plan, rows,
                        **kw)

        hashgrid_cuda._stochastic_call = rec_call
        try:
            cli.main([scene, '--proposal', '--factor-train', '1', *flags,
                      '--iters', str(iters),
                      '--workspace', os.path.join(root, run)])
        finally:
            hashgrid_cuda._stochastic_call = call
        out[run] = rec['last']
    return out


def _stochastic_cases(pkg, seed, samples):
    """K6 (training form) and K7 through pkg's wrappers on each run's
    recorded (table, x), with u and g made from seed and K7 fed this
    tree's K6 rows; K7's compare is the worst share of its tolerance, and
    its fourth element the index_add_ yardstick."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda as ours
    g = torch.Generator(device='cuda').manual_seed(seed + 1)
    cases = {}
    for run, (table, x, config, interp, n_samples, plan) in samples.items():
        n = x.shape[0]
        u = torch.rand(ours.encoders.uniform_shape(
            config.n_levels, n, interp, n_samples), generator=g,
            device='cuda')
        cot = torch.randn((n, config.out_dim), generator=g, device='cuda')
        _, idx, w = ours._stochastic_call(table, x, u, config, interp,
                                          n_samples, plan, True)
        tol = ours.stochastic_backward_tolerance(cot, idx, w, plan, config,
                                                 n_samples)

        def used(a, b, tol=tol):
            return float(((a - b).abs() / tol.clamp(min=1e-38)).max())

        cases[f'K6 cli {run} step N={n}'] = (
            lambda table=table, x=x, u=u, config=config, interp=interp,
            n_samples=n_samples, plan=plan: pkg.hashgrid_cuda.
            _stochastic_call(table, x, u, config, interp, n_samples, plan,
                             True), 20, None)
        cases[f'K7 cli {run} step N={n}'] = (
            lambda cot=cot, idx=idx, w=w, plan=plan, config=config,
            n_samples=n_samples: pkg.hashgrid_cuda._stochastic_scatter_call(
                cot, idx, w, plan, config, n_samples), 20, used,
            k7_yardstick(ours.encoders, cot, idx, w, plan, config,
                         n_samples))
    return cases


def _timed(fn, reps=20):
    """(events ms, device ms) a call of fn."""
    by_kernel = _kernel_ms(fn)
    return _cuda_ms(fn, reps), (None if by_kernel is None
                                else sum(by_kernel.values()))


def _stochastic_parts(gpu, samples, seed):
    """This tree's K6 parts (and, on narrow rows, its level groupings) and
    K7's levels alone on each run's recorded inputs, and the distinct rows
    a tile of K7's points names per level."""
    import torch
    from autolabel_tpu_torch.ops import hashgrid_cuda as hg
    g = torch.Generator(device='cuda').manual_seed(seed + 2)
    out = {}
    for run, (table, x, config, interp, n_samples, plan) in samples.items():
        n, f = x.shape[0], config.n_features
        u = torch.rand(hg.encoders.uniform_shape(
            config.n_levels, n, interp, n_samples), generator=g,
            device='cuda')
        res = out[run] = {'K6': {}, 'K7': {}}
        wide = f % 4 == 0 and f >= 32
        variants = [(part, 0) for part in hg.K6_PARTS] + (
            [] if wide else [('all', 1), ('all', 4)])
        for part, group in variants:
            ms, dev = _timed(lambda part=part, group=group: hg._stochastic_call(
                table, x, u, config, interp, n_samples, plan, True, part,
                group))
            res['K6'][f'{part} group {group}'] = dict(ms=ms, device_ms=dev)
            print(f'K6 part cli {run} [{gpu}] {part}'
                  + (f' (levels a thread {group})' if group else '')
                  + f': {ms:.4f} ms by events, {dev} ms device')
        _, idx, w = hg._stochastic_call(table, x, u, config, interp,
                                        n_samples, plan, True)
        cot = torch.randn((n, config.out_dim), generator=g, device='cuda')
        dtable = torch.zeros(hg._table_shape(config), device='cuda')
        # K7's tiles: 32 points of every row of a level (wide), a warp's
        # 32 points of one row (narrow)
        tile = 32
        for l, (_, rows, first, _) in enumerate(
                hg.encoders.plan_starts(plan)):
            m = n // tile * tile
            t = idx[first:first + rows, :m].reshape(rows, -1, tile)
            t = (t.permute(1, 0, 2).reshape(m // tile, -1) if wide
                 else t.reshape(-1, tile)).sort(dim=1).values
            distinct = int((t[:, 1:] != t[:, :-1]).sum()) + t.shape[0]
            ms, dev = _timed(lambda l=l: hg._stochastic_scatter_call(
                cot, idx, w, plan, config, n_samples, l, dtable))
            res['K7'][l] = dict(entries=rows * m, distinct=distinct, ms=ms,
                                device_ms=dev)
            print(f'K7 level {l} cli {run} [{gpu}] N={n}: {rows * m} rows, '
                  f'{distinct} distinct in tiles of {tile} points; '
                  f'{ms:.4f} ms by events, {dev} ms device')
        del idx, w, cot, dtable, u
        torch.cuda.empty_cache()
    return out


def _same_selection(a, b):
    """0.0 where two K5 outputs (sel, coef, count) draw the same points with
    bit-equal coefs, else 1.0."""
    import torch
    m = int(a[2][0])
    same = (m == int(b[2][0]) and torch.equal(a[0][:m], b[0][:m])
            and torch.equal(a[1][:m], b[1][:m]))
    return 0.0 if same else 1.0


def _cases(pkg, seed, step_samples, flagship, cli_samples):
    """{name: (fn(pkg), reps, compare)}: each kernel of the main path called
    through pkg's wrappers on inputs made from seed (the same for every
    pkg), K2 on a training step's recorded samples, K5, K2s and K1s on a
    flagship step's, K1s also on a CLI step's; compare(old, new) of their
    outputs, None for the largest absolute difference."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dev = torch.device('cuda')
    grid, ref = pkg.encoders.TPU_GRID, pkg.encoders.HashGridConfig()
    n1, n2, n4 = 524288, 131072, 1048576
    x = torch.rand((n1, 3), generator=g).to(dev)
    table = (torch.randn((grid.n_levels, grid.table_size, grid.n_features),
                         generator=g) * 0.5).to(dev)
    table_ref = (torch.randn((ref.n_levels, ref.table_size,
                              ref.n_features), generator=g) * 0.5).to(dev)
    g2 = torch.randn((n2, grid.out_dim), generator=g).to(dev)
    x2 = x[:n2].contiguous()
    # chip_smoke.py's heads: hidden 128, geo 15, 64 semantic features, 6
    # classes; A the TPU_GRID encode's width
    init = pkg.mlp.mlp_init
    params = {'sigma_net': init(g, 12 + grid.out_dim, 128, 16, 2),
              'color_net': init(g, 16 + 15, 128, 3, 2),
              'semantic_features': init(g, 15, 64, 64, 2),
              'semantic_out': init(g, 64 + 15, 64, 6, 1)}
    packed = [w.to(dev).to(torch.bfloat16)
              for w in pkg.heads_cuda.pack_head_weights(params, 12)]
    A = torch.randn((n1, grid.out_dim), generator=g).to(dev) * 0.5
    B = torch.zeros((n1, 32), device=dev)
    B[:, :12] = torch.rand((n1, 12), generator=g).to(dev) * 2 - 1
    B[:, 16:32] = torch.randn((n1, 16), generator=g).to(dev) * 0.3
    A2, B2 = A[:n2].contiguous(), B[:n2].contiguous()
    cots = [torch.randn((n2, packed[i].shape[1]), generator=g).to(dev)
            for i in (7, 10, 13)]
    ws = [w.to(dev).to(torch.bfloat16)
          for w in pkg.heads_cuda.pack_mlp3(init(g, 36, 64, 1, 2))]
    X = (torch.rand((n4, 36), generator=g) * 2 - 1).to(dev)
    X4, g4 = X[:n4 // 4].contiguous(), torch.randn(
        (n4 // 4, ws[2].shape[1]), generator=g).to(dev)
    hg, hd = pkg.hashgrid_cuda, pkg.heads_cuda
    g_s, x_s = step_samples
    f = flagship
    g_f, u_f, k_f, fl_grid = f['g'], f['u'], f['k'], f['grid']
    idx_f, w_f, rows_f = f['atoms']
    sel_f, coef_f, count_f = f['selection']
    n_f, m_f = g_f.shape[0], int(count_f[0])
    k1s = {}
    for where, ((t_e, x_e), grid_e) in (('flagship step', (f['encode'],
                                                          fl_grid)),
                                       ('cli step', cli_samples)):
        for interp in ('simplex', 'trilinear'):
            for form, dtype, atoms in (
                    ('training', torch.bfloat16, True),
                    ('eval', torch.float32, False)):
                k1s[f'K1s {interp} {form} {where} N={x_e.shape[0]}'] = (
                    lambda t_e=t_e, x_e=x_e, grid_e=grid_e, interp=interp,
                    dtype=dtype, atoms=atoms: hg.encode_atoms(
                        t_e, x_e, grid_e, interp, dtype, atoms), 20, None)
    return {
        **k1s,
        f'K1 TPU_GRID N={n1}': (lambda: hg.hashgrid_encode(table, x, grid),
                                20, None),
        f'K1 reference N={n1}': (
            lambda: hg.hashgrid_encode(table_ref, x, ref), 20, None),
        f'K2 TPU_GRID N={n2}': (
            lambda: hg.hashgrid_encode_backward(g2, x2, grid), 20, None),
        f'K2 TPU_GRID step samples N={x_s.shape[0]}': (
            lambda: hg.hashgrid_encode_backward(g_s, x_s, grid), 20, None),
        f'K3f N={n1}': (lambda: hd.fused_heads(packed, A, B), 10, None),
        f'K3b N={n2}': (lambda: hd.fused_heads_backward(
            packed, A2, B2, *cots, need_dB=False), 10, None),
        f'K4f N={n4}': (lambda: hd.fused_mlp3(ws, X), 20, None),
        f'K4b N={n4 // 4}': (
            lambda: hd.fused_mlp3_backward(ws, X4, g4), 20, None),
        f'K5 flagship step N={n_f} k={k_f}': (
            lambda: hg.select_points(g_f, u_f, k_f), 20, _same_selection),
        f'K2s flagship step N={n_f} drawn={m_f}': (
            lambda: hg.sampled_scatter(g_f, idx_f, w_f, u_f, rows_f, fl_grid,
                                       sel_f, coef_f, count_f), 20, None),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent', default=os.path.join(HERE, 'build',
                                                         'parent'))
    parser.add_argument('--rounds', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--only', default='',
                        help='regular expression of the cases to run')
    args = parser.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('kernel_compare: no CUDA device', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(args.parent, PKG)):
        print(f'kernel_compare: no {PKG} under {args.parent}',
              file=sys.stderr)
        return 2
    only = re.compile(args.only)
    sides = {'old': _load(os.path.abspath(args.parent)), 'new': _load(HERE)}
    for pkg in sides.values():
        pkg.kernels.build_all()
    gpu = _gpu_line()
    result = {'gpu': gpu, 'rounds': args.rounds, 'kernels': {}}
    cases = {side: {} for side in sides}
    def wanted(names):
        return any(only.search(name) for name in names)

    if wanted(('K1 TPU_GRID', 'K1 reference', 'K2 TPU_GRID', 'K3f', 'K3b',
               'K4f', 'K4b', 'K5 flagship', 'K2s flagship', 'K1s simplex',
               'K1s trilinear')):
        step_samples = _step_samples(args.seed)
        flagship = _flagship_samples(args.seed)
        cli_samples = _cli_samples()
        for side, pkg in sides.items():
            cases[side].update(_cases(pkg, args.seed, step_samples,
                                      flagship, cli_samples))
    stochastic = None
    if wanted([f'{k} cli {run} step' for k in ('K6', 'K7')
               for run in STOCHASTIC_RUNS]):
        stochastic = _stochastic_samples()
        for side, pkg in sides.items():
            cases[side].update(_stochastic_cases(pkg, args.seed, stochastic))
    for name in [k for k in cases['new'] if only.search(k)]:
        old, reps, compare, *library = cases['old'][name]
        new = cases['new'][name][0]
        diff = (compare or _max_diff)(old(), new())
        sided = {'old': old, 'new': new}
        if library:
            sided['library'] = library[0]
        times = {k: [] for k in sided}
        device = {k: [] for k in sided}
        for r in range(args.rounds):
            order = list(sided) if r % 2 == 0 else list(sided)[::-1]
            for side in order:
                fn = sided[side]
                times[side].append(_cuda_ms(fn, reps))
                by_kernel = _kernel_ms(fn)
                device[side].append(None if by_kernel is None
                                    else sum(by_kernel.values()))
        med = {k: float(np.median(v)) for k, v in times.items()}
        dev_med = {k: None if None in v else float(np.median(v))
                   for k, v in device.items()}
        result['kernels'][name] = dict(max_diff_old_new=diff, ms=times,
                                       median_ms=med, device_ms=device,
                                       median_device_ms=dev_med)
        what = ('selections differ' if diff else 'selections equal') \
            if compare is _same_selection else (
                f'worst |new - old| uses {diff:.3f} of the tolerance'
                if compare else f'max |new - old| {diff:.3e}')
        dev_text = ('device ms not measured'
                    if None in (dev_med['old'], dev_med['new'])
                    else f'device old {dev_med["old"]:.4f} ms, new '
                         f'{dev_med["new"]:.4f} ms (new/old '
                         f'{dev_med["new"] / dev_med["old"]:.3f})')
        lib_text = '' if not library else (
            f'; index_add_ {med["library"]:.4f} ms by events, '
            f'{dev_med["library"]} ms device')
        print(f'{name} [{gpu}]: old {med["old"]:.4f} ms, new '
              f'{med["new"]:.4f} ms (new/old {med["new"] / med["old"]:.3f}) '
              f'by events; {dev_text}{lib_text}; {what}; rounds old '
              f'{[round(v, 4) for v in times["old"]]} new '
              f'{[round(v, 4) for v in times["new"]]}')
        torch.cuda.empty_cache()
    if stochastic is not None:
        del cases
        torch.cuda.empty_cache()
        result['stochastic_parts'] = _stochastic_parts(gpu, stochastic,
                                                       args.seed)
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'kernel_compare.json'),
              'w') as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
