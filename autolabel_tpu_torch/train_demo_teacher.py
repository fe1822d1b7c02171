"""Train the DemoCLIP text + pixel teacher on a labelled scene.

    python -m autolabel_tpu_torch.train_demo_teacher <scene> \
        [--out demo_teacher.npz] [--prompts prompts.json] [--iters 1500]

Counterpart of scripts/train_demo_teacher.py, with its flags and defaults:
it writes the .npz checkpoint that `--features demo` reads
(compute_feature_maps, language.evaluate, the render CLI), in the format
both packages read (features/demo_clip.py). --prompts: an optional JSON
{class_id: [synonym, ...]}; the room scene's bank by default.

It runs on the card; tests call main([...], device='cpu').
"""
import argparse
import json
import os

from autolabel_tpu_torch.features import demo_clip


def read_args(argv=None):
    """scripts/train_demo_teacher.py's flags; argv defaults to
    sys.argv[1:]."""
    parser = argparse.ArgumentParser()
    parser.add_argument('scene', type=str)
    parser.add_argument('--out', type=str, default=None,
                        help="Checkpoint path (default "
                        "<scene>/demo_teacher.npz).")
    parser.add_argument('--prompts', type=str, default=None,
                        help="JSON file mapping class id -> prompt "
                        "synonyms (default: the room-scene bank).")
    parser.add_argument('--iters', type=int, default=1500)
    parser.add_argument('--crop', type=int, default=96)
    parser.add_argument('--lr', type=float, default=2e-3)
    parser.add_argument('--frames-stride', type=int, default=4)
    parser.add_argument('--seed', type=int, default=0)
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Train and write the checkpoint; returns its path. device: None (the
    card; raises without one) or a torch device ('cpu' in the tests)."""
    flags = read_args(argv)
    prompt_bank = None
    if flags.prompts:
        with open(flags.prompts) as f:
            prompt_bank = {int(k): v for k, v in json.load(f).items()}
    out = flags.out or os.path.join(flags.scene, 'demo_teacher.npz')
    demo_clip.train_demo_teacher(flags.scene, out,
                                 prompt_bank=prompt_bank,
                                 iters=flags.iters,
                                 crop=flags.crop,
                                 lr=flags.lr,
                                 seed=flags.seed,
                                 frames_stride=flags.frames_stride,
                                 device=device)
    print(f"wrote {out}")
    return out


if __name__ == '__main__':
    main()
