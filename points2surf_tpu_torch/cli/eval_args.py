"""Evaluation CLI flags (counterpart of ``points2surf_tpu/cli/eval_args.py``)
— same names and defaults as the reference
(source/points_to_surf_eval.py:16-65). ``--gpu_idx`` chooses the card
(``cuda:<idx>``)."""

from __future__ import annotations

import argparse


def parse_arguments(args=None):
    parser = argparse.ArgumentParser()

    parser.add_argument('--indir', type=str, default='datasets/abc_minimal')
    parser.add_argument('--outdir', type=str, default='results')
    parser.add_argument('--dataset', nargs='+', type=str,
                        default=['testset.txt'])
    parser.add_argument('--reconstruction', type=bool, default=False)
    parser.add_argument('--query_grid_resolution', type=int, default=None)
    parser.add_argument('--epsilon', type=int, default=None)
    parser.add_argument('--certainty_threshold', type=float, default=None)
    parser.add_argument('--sigma', type=int, default=None)
    parser.add_argument('--up_sampling_factor', type=int, default=10,
                        help='accepted for reference-CLI compatibility but '
                             'UNUSED (declared-but-dead in the reference '
                             'too, points_to_surf_eval.py:30-50)')
    parser.add_argument('--modeldir', type=str, default='models')
    parser.add_argument('--models', type=str, default='p2s_vanilla')
    parser.add_argument('--modelpostfix', type=str, default='_model.npz')
    parser.add_argument('--parampostfix', type=str, default='_params.json')
    parser.add_argument('--gpu_idx', type=int, default=0,
                        help='card to evaluate on (cuda:<idx>)')
    parser.add_argument('--sparse_patches', type=int, default=False,
                        help='accepted for reference-CLI compatibility but '
                             'UNUSED (declared-but-dead in the reference '
                             'too); use --sampling to thin the queries')
    parser.add_argument('--sampling', type=str, default='full')
    parser.add_argument('--patches_per_shape', type=int, default=1000)
    parser.add_argument('--query_points_per_patch', type=int, default=1,
                        help='accepted for reference-CLI compatibility but '
                             'UNUSED (declared-but-dead in the reference '
                             'too)')
    parser.add_argument('--sub_sample_size', type=int, default=500)
    parser.add_argument('--seed', type=int, default=40938661)
    parser.add_argument('--batchSize', type=int, default=0)
    parser.add_argument('--workers', type=int, default=0)
    parser.add_argument('--cache_capacity', type=int, default=100)
    parser.add_argument('--exact_patch_sampling', type=int, default=0,
                        help='1: skip the tile attempt and the candidate '
                             'decimation (selection is exact either way)')
    parser.add_argument('--eval_dtype', type=str, default='auto',
                        choices=['auto', 'float32', 'bfloat16'],
                        help='inference activation dtype; auto = the '
                             'checkpoint\'s training dtype. float32 is '
                             'the only one ported: bfloat16 is accepted '
                             'and the model load raises')

    opt = parser.parse_args(args=args)
    # surface non-default values of the dead compatibility flags instead of
    # silently ignoring them
    for flag, default in (("up_sampling_factor", 10),
                          ("sparse_patches", False),
                          ("query_points_per_patch", 1)):
        if getattr(opt, flag) != default:
            print(f"WARNING: --{flag} is accepted for reference-CLI "
                  "compatibility but has no effect (declared-but-unused "
                  "in the reference as well)")
    if len(opt.dataset) == 1:
        opt.dataset = opt.dataset[0]
    return opt
