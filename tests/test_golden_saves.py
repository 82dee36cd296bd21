"""Golden-saves regression harness.

Device-side equivalent of the reference's etalon-saves comparison
(src/test/teamcity/teamcity.py:86-93 ``detect_diffs.sh`` /
``compare_saves.sh``): run the toy E. coli 1K pipeline with
``--checkpoints all``, fingerprint every per-stage checkpoint
(saves/<stage>/pack.npz + pack.json), and diff against checked-in
goldens so refactors cannot silently change intermediate state.

Regenerate after an *intentional* behavior change with:

    REGEN_GOLDENS=1 python -m pytest tests/test_golden_saves.py -q
"""

import hashlib
import json
import os

import numpy as np
import pytest

DATASET = "/root/reference/assembler/test_dataset"
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "ecoli1k_saves.json")

pytestmark = [pytest.mark.slow, pytest.mark.skipif(
    not os.path.isdir(DATASET), reason="toy dataset unavailable")]


def _fingerprint_stage(stage_dir: str) -> dict:
    """Stable digest of one stage checkpoint.

    Hashes every array's (dtype, shape, bytes) plus the normalized JSON
    metadata. Floats are rounded to 6 significant decimals before
    hashing so bit-level jitter in reductions doesn't flag a diff while
    genuine value changes still do.
    """
    out = {}
    with np.load(os.path.join(stage_dir, "pack.npz")) as data:
        for name in sorted(data.files):
            arr = np.asarray(data[name])
            h = hashlib.sha256()
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            if arr.dtype.kind == "f":
                h.update(np.round(arr.astype(np.float64), 6).tobytes())
            else:
                h.update(np.ascontiguousarray(arr).tobytes())
            out[name] = h.hexdigest()[:16]
    with open(os.path.join(stage_dir, "pack.json")) as f:
        meta = json.load(f)
    # round floats inside meta (coverage values etc.) for stability
    def _norm(x):
        if isinstance(x, float):
            return round(x, 6)
        if isinstance(x, list):
            return [_norm(v) for v in x]
        if isinstance(x, dict):
            return {k: _norm(v) for k, v in sorted(x.items())}
        return x
    blob = json.dumps(_norm(meta), sort_keys=True).encode()
    out["pack.json"] = hashlib.sha256(blob).hexdigest()[:16]
    return out


def test_golden_saves(tmp_path):
    from spades_for_blackbird_tpu import cli

    out = tmp_path / "out"
    rc = cli.main(["--test", "-o", str(out), "-k", "21,33",
                   "--checkpoints", "all"])
    assert rc == 0

    saves = out / "saves"
    # stage checkpoints only: saves/phases holds intra-stage phase
    # checkpoints (pre_simplify_k*.npz), not stage packs
    stages = sorted(d for d in os.listdir(saves)
                    if os.path.isdir(saves / d)
                    and os.path.exists(saves / d / "pack.npz"))
    assert stages, "no stage saves written"
    got = {s: _fingerprint_stage(str(saves / s)) for s in stages}

    if os.environ.get("REGEN_GOLDENS"):
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        with open(GOLDEN, "w") as f:
            json.dump(got, f, indent=1, sort_keys=True)
        pytest.skip(f"goldens regenerated at {GOLDEN}")

    if not os.path.exists(GOLDEN):
        pytest.fail("goldens missing; run with REGEN_GOLDENS=1 to create")

    with open(GOLDEN) as f:
        want = json.load(f)

    diffs = []
    for s in sorted(set(want) | set(got)):
        if s not in got:
            diffs.append(f"stage {s}: missing from run")
            continue
        if s not in want:
            diffs.append(f"stage {s}: new (not in goldens)")
            continue
        for key in sorted(set(want[s]) | set(got[s])):
            if want[s].get(key) != got[s].get(key):
                diffs.append(f"stage {s} / {key}: "
                             f"{want[s].get(key)} -> {got[s].get(key)}")
    assert not diffs, ("stage saves drifted vs goldens "
                       "(REGEN_GOLDENS=1 if intentional):\n"
                       + "\n".join(diffs))
