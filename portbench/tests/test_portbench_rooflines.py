"""Each kernel's bytes-once count at small shapes, against what the
program's launch reads and writes (its plain form, on the CPU), counted at
the reads' real length and 4 bytes a 32-bit limb."""

import numpy as np
import pytest
import torch

from portbench import roofline

CFG = {"reads": {"length": 150}, "k": 31, "msp": {"shards": 8}}
PADDED = 160  # the program's row width for 150-base reads


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("n", [1, 37, 100])
def test_extract_canonical_bytes(n):
    from tpu_debruijn_torch.kernels.extract_canonical import extract_canonical_plain
    from tpu_debruijn_torch.kmer import KmerSpec

    shape = roofline.shape_of(CFG, n, 0)
    bases = torch.randint(0, 4, (n, PADDED), dtype=torch.uint8)
    lengths = torch.full((n,), 150, dtype=torch.int32)
    seq_exts = torch.zeros(n, dtype=torch.int32)
    kmers, exts, valid = extract_canonical_plain(KmerSpec(31), bases, lengths, seq_exts, False)
    obs = int(valid.sum())
    assert obs == shape["observations"] == n * (150 - 31 + 1)
    want = (nbytes(bases[:, :150], lengths, seq_exts)
            + obs * (4 * kmers.shape[-1] + exts.element_size() + valid.element_size()))
    assert roofline.kernel("extract_canonical").job_bytes(shape) == want
    assert roofline.kernel("extract_canonical").launches(shape) == 1


@pytest.mark.parametrize("n", [1, 37])
def test_run_reduce_rows_bytes(n):
    from tpu_debruijn_torch.filter import obs_row_words

    shape = roofline.shape_of(CFG, n, 17)
    rows = n * (150 - 31 + 1)
    want = rows * 4 * obs_row_words(2) + 17 * 4 * obs_row_words(2) + 4
    assert roofline.kernel("run_reduce_rows").job_bytes(shape) == want


@pytest.mark.parametrize("n", [8, 37, 100])
def test_msp_scan_reads_bytes(n):
    from tpu_debruijn_torch.kernels.msp_scan import msp_scan_reads_plain
    from tpu_debruijn_torch.parallel.shard import source_blocks

    shape = roofline.shape_of(CFG, n, 0)
    total, launches = 0, 0
    for lo, hi in source_blocks(n, 8):
        if hi > lo:
            bases = torch.randint(0, 4, (hi - lo, PADDED), dtype=torch.uint8)
            outs = msp_scan_reads_plain(bases, 31, 8)
            positions = (hi - lo) * (150 - 31 + 1)
            total += nbytes(bases[:, :150]) + positions * sum(o.element_size() for o in outs)
            launches += 1
    mod = roofline.kernel("msp_scan_reads")
    assert mod.job_bytes(shape) == total and mod.launches(shape) == launches


def test_share_needs_every_launch():
    import types

    shape = roofline.shape_of(CFG, 928_331, 20_825_418)
    mod = roofline.kernel("run_reduce_rows")
    tr = types.SimpleNamespace(kernels={mod.KERNEL: (2, 2e-3)})
    ctx = types.SimpleNamespace(trace=tr, jobs=2, shape=shape, device_kind="NVIDIA H100 80GB HBM3")
    least = 2 * mod.job_bytes(shape) / 3.35e12
    assert np.isclose(roofline.share(ctx, "run_reduce_rows"), 100 * least / 2e-3)
    ctx.jobs = 3
    assert roofline.share(ctx, "run_reduce_rows") is None
