"""Multi-process collectives — the sharded regimes executed across a
REAL process boundary via jax.distributed (2 OS processes x 4 virtual
CPU devices each). This is the code path that carries traffic between
hosts; the reference has no analogue at all (single GPU,
src/kernelprovider.cuh:30).

Runs benchmarks/dcn_multiprocess.py at a small config (n=256, 2 data
limbs) covering all four regimes: cross-process DP placement,
limb-sharding whose key-switch psum crosses the boundary, the 2-D
mesh with tp pairs spanning both processes, and the app-layer
MatmulHelper tile contraction with its output-tile axis split across
the boundary. Every regime must match a single-device replay
word-for-word and decrypt exactly.
"""

import json
import os
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "benchmarks", "dcn_multiprocess.py")



def test_dcn_multiprocess_small(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("PYTHONSTARTUP", None)
    env["TROY_DCN_N"] = "256"
    env["TROY_DCN_QBITS"] = "40,40,40"     # 2 data limbs + special
    env["TROY_DCN_TBITS"] = "17"
    env["TROY_DCN_MM"] = "8,32,32"         # app tiles: Y=4, splits over 2
    env["TROY_DCN_PORT"] = "12961"
    out_json = str(tmp_path / "multiprocess.json")
    env["TROY_DCN_OUT"] = out_json
    # do not inherit the suite's 8-device XLA flag: workers set their own
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, SCRIPT], env=env,
                         capture_output=True, text=True, timeout=850)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    with open(out_json) as f:
        rec = json.load(f)
    assert rec["ok"] is True
    assert rec["processes"] == 2
    assert rec["regimes"] == {"dp8": True, "tp2x": True, "dp4tp2x": True,
                              "app2x": True}
