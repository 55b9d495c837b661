#!/usr/bin/env bash
# Full test suite, one pytest process per test file.
#
# Rationale: a single pytest process over all ~250 cases accumulates
# hundreds of XLA CPU executables and sporadically dies with
# SIGSEGV/SIGABRT inside jax's compilation-cache write path (observed
# on this jaxlib; per-file processes have never crashed).  Per-file
# isolation also keeps any one crash from masking the rest of the
# suite's results.  The persistent compilation cache makes the extra
# process startups cheap.
#
# Usage: bash tools/run_suite.sh [extra pytest args]
set -u
cd "$(dirname "$0")/.."

pass=0; fail=0; failed_files=()
for f in tests/test_*.py; do
  echo "== $f" >&2
  env JAX_PLATFORMS=cpu timeout 2400 \
      python -m pytest "$f" -q -p no:cacheprovider "$@" >&2
  rc=$?
  # rc=5: no tests collected/selected (e.g. a slow-only file without
  # -m slow) — a skip, not a failure
  if [ $rc -eq 0 ] || [ $rc -eq 5 ]; then
    pass=$((pass+1))
  else
    fail=$((fail+1)); failed_files+=("$f")
  fi
done
echo "files passed: $pass, failed: $fail"
if [ $fail -gt 0 ]; then
  printf 'FAILED: %s\n' "${failed_files[@]}"
  exit 1
fi
echo "SUITE PASS"
