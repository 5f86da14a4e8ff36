"""Pallas gapped-extension kernels wired into the production stream:
with cfg.device_extension the DP-triggering normal pairs run through
ops/nw_device / ops/ksw2_device in one batch; outputs must be
bit-identical to the scalar path (they are bit-identical aligners)."""
import time

import numpy as np
import pytest

from mapcaller.config import Config
from mapcaller.dna import decode
from mapcaller.index.fmindex import build_index
from mapcaller.index.packer import PackedReference
from mapcaller.pipeline.device_backend import DeviceBackend
from mapcaller.pipeline.engine import MappingEngine
from mapcaller.pipeline.stream import run_stream_mapping


@pytest.fixture(scope="module")
def divergent(tmp_path_factory):
    """Reads with dense mismatch blocks and indels: every one slow-class,
    most triggering the gapped DP (mis>1 && mis>=len//5)."""
    tmp = tmp_path_factory.mktemp("devdp")
    rng = np.random.default_rng(5)
    L = 30000
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    ref = PackedReference(["chr1"], [L], [0], codes, [])
    idx = build_index(None, packed=ref)
    fq = tmp / "d.fq"
    RL = 100
    with open(fq, "w") as f:
        k = 0
        for p in range(100, L - 200, 37):
            c = codes[p:p + RL].copy()
            mode = k % 3
            if mode == 0:     # scrambled block => equal-length DP pair
                j = 30 + (k % 25)
                c[j:j + 6] = (c[j:j + 6] + 1 + rng.integers(0, 3, 6)) % 4
            elif mode == 1:   # deletion => length-mismatch DP pair
                c = np.concatenate([codes[p:p + 40],
                                    codes[p + 44:p + 44 + RL - 40]])[:RL]
            else:             # insertion
                ins = rng.integers(0, 4, 5).astype(np.uint8)
                c = np.concatenate([codes[p:p + 50], ins,
                                    codes[p + 50:p + RL - 5]])[:RL]
            f.write(f"@d{k}\n{decode(c)}\n+\n{'I' * RL}\n")
            k += 1
    return idx, str(fq)


@pytest.mark.parametrize("use_nw", [True, False])
def test_device_extension_bit_identical(divergent, tmp_path, use_nw):
    idx, fq = divergent
    outs = {}
    for dev_ext in (False, True):
        cfg = Config(sam_file="x", vcf_file=str(tmp_path / f"{dev_ext}.vcf"),
                     log_file=str(tmp_path / f"{dev_ext}.log"),
                     batch_size=512, stream_batch_size=512,
                     max_read_len=128, use_nw=use_nw,
                     device_extension=dev_ext)
        backend = DeviceBackend(idx, cfg)
        eng = MappingEngine(idx, cfg, backend=backend)
        cfg.read_files1, cfg.read_files2 = [fq], []
        parts = []
        run_stream_mapping(eng, cfg, time.time(), parts.append)
        eng.finalize()
        eng.materialize_profile()
        outs[dev_ext] = ("".join(parts),
                         eng.profile.acgt.copy(),
                         dict(eng.profile.insert_map),
                         dict(eng.profile.delete_map),
                         eng.stats.total_mapped)
    assert outs[False][0] == outs[True][0], "SAM text differs"
    assert np.array_equal(outs[False][1], outs[True][1]), "acgt planes"
    assert outs[False][2] == outs[True][2]
    assert outs[False][3] == outs[True][3]
    assert outs[False][4] == outs[True][4]
    assert outs[False][4] > 0
    # the divergent set must actually exercise the DP path
    assert len(outs[False][3]) > 0 or len(outs[False][2]) > 0
