#!/usr/bin/env bash
# CPU smoke verification: fast tests, a tiny CLI render and the
# multi-device dryrun on 8 virtual CPU devices.  The GPU counterpart is
# `python chip_smoke.py`.
#
#   bash tools/smoke.sh          # ~3 min: core math/sampling tests + a render
#   bash tools/smoke.sh full     # the whole suite (slow on 1 core)
set -eu
cd "$(dirname "$0")/.."

RUN=(env JAX_PLATFORMS=cpu
     XLA_FLAGS=--xla_force_host_platform_device_count=8)

if [[ "${1:-}" == "full" ]]; then
  # one pytest process per file: a single process over all ~250 cases
  # sporadically dies in jax's compilation-cache write (see
  # tools/run_suite.sh)
  exec bash tools/run_suite.sh
fi

echo "== fast statistical tests (no compile-heavy renders) =="
"${RUN[@]}" python -m pytest tests/test_warp.py tests/test_rng.py \
  tests/test_math.py tests/test_poisson.py tests/test_scene_io.py -q

echo "== tiny end-to-end render through the CLI =="
"${RUN[@]}" python -m gradientdomain_mitsuba_tpu.utils.cli \
  data/scenes/cbox/cbox.xml -o /tmp/smoke.exr \
  -D integrator=gpt -D width=32 -D height=32 -D spp=2 -D maxDepth=3
"${RUN[@]}" python - <<'EOF'
import numpy as np
from gradientdomain_mitsuba_tpu.utils.exr import read_rgb
img = read_rgb("/tmp/smoke.exr")
assert img.shape == (32, 32, 3) and np.isfinite(img).all()
assert img.mean() > 1e-3
print("smoke render OK: mean", float(img.mean()))
EOF

echo "== multi-chip dryrun (8 virtual CPU devices) =="
"${RUN[@]}" python __graft_entry__.py 8
echo "SMOKE PASS"
