#!/usr/bin/env python3
"""Time the port's kernels against another checkout's, in turns, on one
CUDA card.

    git archive <commit> autolabel_tpu_torch | tar -x -C build/parent
    python3 kernel_compare.py [--parent build/parent] [--rounds 4]

Both packages are imported side by side, each as a module tree of its own
that builds its kernels into a build directory beside itself, and every
kernel of the main path is called through each package's public wrapper
on the same inputs: K1 at TPU_GRID (wide rows) and at the reference preset
(narrow rows), K2, K3f, K3b, K4f and K4b at chip_smoke.py's shapes, and K2
also on the (g, x) of a step of chip_smoke.py's training slice. Each
kernel's old and new outputs are compared (largest absolute difference;
0 means bit-equal), then both are timed by CUDA events, old, new, new,
old, ... for --rounds rounds. Prints one line per kernel and writes
chiprun_out/kernel_compare.json.
"""
import argparse
import importlib
import json
import os
import sys
import types

from chip_smoke import _cuda_ms, _gpu_line

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


def _cases(pkg, seed, step_samples):
    """{name: (fn(pkg), reps)}: each kernel of the main path called through
    pkg's wrappers on inputs made from seed (the same for every pkg), and
    K2 on a training step's recorded samples."""
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
    return {
        f'K1 TPU_GRID N={n1}': (lambda: hg.hashgrid_encode(table, x, grid),
                                20),
        f'K1 reference N={n1}': (
            lambda: hg.hashgrid_encode(table_ref, x, ref), 20),
        f'K2 TPU_GRID N={n2}': (
            lambda: hg.hashgrid_encode_backward(g2, x2, grid), 20),
        f'K2 TPU_GRID step samples N={x_s.shape[0]}': (
            lambda: hg.hashgrid_encode_backward(g_s, x_s, grid), 20),
        f'K3f N={n1}': (lambda: hd.fused_heads(packed, A, B), 10),
        f'K3b N={n2}': (lambda: hd.fused_heads_backward(
            packed, A2, B2, *cots, need_dB=False), 10),
        f'K4f N={n4}': (lambda: hd.fused_mlp3(ws, X), 20),
        f'K4b N={n4 // 4}': (
            lambda: hd.fused_mlp3_backward(ws, X4, g4), 20),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent', default=os.path.join(HERE, 'build',
                                                         'parent'))
    parser.add_argument('--rounds', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
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
    sides = {'old': _load(os.path.abspath(args.parent)), 'new': _load(HERE)}
    for pkg in sides.values():
        pkg.kernels.build_all()
    gpu = _gpu_line()
    result = {'gpu': gpu, 'rounds': args.rounds, 'kernels': {}}
    step_samples = _step_samples(args.seed)
    cases = {side: _cases(pkg, args.seed, step_samples)
             for side, pkg in sides.items()}
    for name in cases['new']:
        (old, reps), (new, _) = cases['old'][name], cases['new'][name]
        diff = _max_diff(old(), new())
        times = {'old': [], 'new': []}
        for r in range(args.rounds):
            for side in (('old', 'new') if r % 2 == 0 else ('new', 'old')):
                fn = old if side == 'old' else new
                times[side].append(_cuda_ms(fn, reps))
        med = {k: float(np.median(v)) for k, v in times.items()}
        result['kernels'][name] = dict(max_diff_old_new=diff, ms=times,
                                       median_ms=med)
        print(f'{name} [{gpu}]: old {med["old"]:.4f} ms, new '
              f'{med["new"]:.4f} ms (new/old {med["new"] / med["old"]:.3f}); '
              f'max |new - old| {diff:.3e}; rounds old '
              f'{[round(v, 4) for v in times["old"]]} new '
              f'{[round(v, 4) for v in times["new"]]}')
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(HERE, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(HERE, 'chiprun_out', 'kernel_compare.json'),
              'w') as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
