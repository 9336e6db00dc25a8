"""Training CLI flags (counterpart of ``points2surf_tpu/cli/train_args.py``)
— same names and defaults as the reference
(source/points_to_surf_train.py:28-134), so experiments/*.sh run by swapping
the entry point. ``--gpu_idx`` chooses the card (``cuda:<first index>``).
"""

from __future__ import annotations

import argparse


def parse_arguments(args=None):
    parser = argparse.ArgumentParser()

    parser.add_argument('--name', type=str, default='debug',
                        help='training run name')
    parser.add_argument('--desc', type=str, default='p2s-tpu training run',
                        help='description')
    parser.add_argument('--indir', type=str, default='datasets/abc_minimal',
                        help='input folder (dataset)')
    parser.add_argument('--outdir', type=str, default='models',
                        help='output folder (trained models)')
    parser.add_argument('--logdir', type=str, default='logs',
                        help='training log folder')
    parser.add_argument('--trainset', type=str, default='trainset.txt')
    parser.add_argument('--testset', type=str, default='testset.txt')
    parser.add_argument('--save_interval', type=int, default=10)
    parser.add_argument('--debug_interval', type=int, default=1)
    parser.add_argument('--log_every_batch', type=int, default=0,
                        help='log TensorBoard scalars for EVERY train batch '
                             '(the reference cadence, train.py:474-478) '
                             'instead of every --debug_interval batches; '
                             'each log is one device-to-host copy.')
    parser.add_argument('--train_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help='activation dtype for training. float32 is '
                             'the only one ported: bfloat16 is accepted '
                             'and the model build raises.')
    parser.add_argument('--f32_finetune_epochs', type=int, default=-1,
                        help='with --train_dtype bfloat16, run the final N '
                             'epochs in float32 (precision annealing; '
                             'not ported, no effect in float32).')
    parser.add_argument('--refine', type=str, default='',
                        help='refine model at this path')
    parser.add_argument('--gpu_idx', type=int, default=[0], nargs='+',
                        help='card to train on (cuda:<first index>)')
    parser.add_argument('--patch_radius', type=float, default=0.05,
                        help='<= 0.0 for k-NN patches')

    parser.add_argument('--net_size', type=int, default=1024)
    parser.add_argument('--nepoch', type=int, default=2)
    parser.add_argument('--batchSize', type=int, default=2)
    parser.add_argument('--patch_center', type=str, default='point')
    parser.add_argument('--patch_point_count_std', type=float, default=0)
    parser.add_argument('--patches_per_shape', type=int, default=1000)
    parser.add_argument('--sub_sample_size', type=int, default=500)
    parser.add_argument('--workers', type=int, default=0,
                        help='ignored: patch extraction runs on the card')
    parser.add_argument('--cache_capacity', type=int, default=100)
    parser.add_argument('--seed', type=int, default=3627473)
    parser.add_argument('--single_transformer', type=int, default=0)
    parser.add_argument('--uniform_subsample', type=int, default=0)
    parser.add_argument('--fixed_subsample', type=int, default=0)
    parser.add_argument('--shared_transformer', type=int, default=0)
    parser.add_argument('--training_order', type=str, default='random')
    parser.add_argument('--identical_epochs', type=int, default=False)
    parser.add_argument('--lr', type=float, default=0.001)
    parser.add_argument('--scheduler_steps', type=int, nargs='+',
                        default=[75, 125])
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--normal_loss', type=str, default='ms_euclidean')

    parser.add_argument('--outputs', type=str, nargs='+',
                        default=['imp_surf', 'imp_surf_magnitude',
                                 'imp_surf_sign', 'patch_pts_ids', 'p_index'])
    parser.add_argument('--use_point_stn', type=int, default=True)
    parser.add_argument('--use_feat_stn', type=int, default=True)
    parser.add_argument('--sym_op', type=str, default='max')
    parser.add_argument('--points_per_patch', type=int, default=50)
    parser.add_argument('--debug', type=int, default=0)

    return parser.parse_args(args=args)


def device_of(opt) -> str:
    """The card of ``--gpu_idx``: ``cuda:<first index>``."""
    idx = opt.gpu_idx[0] if isinstance(opt.gpu_idx, (list, tuple)) \
        else opt.gpu_idx
    return f"cuda:{int(idx)}"
