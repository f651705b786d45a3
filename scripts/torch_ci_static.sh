#!/usr/bin/env bash
# The pre-push gate of the PyTorch/CUDA port (scripts/ci_static.sh's
# counterpart): every card-free verification pass in one command, in the
# reference's order —
#
#   - bench-history regression gate: the committed trajectory of
#     bench_torch.py's full-size card runs
#     (scripts/torch_bench_manifest.jsonl, default flags only) against
#     scripts/torch_bench_baseline.json (written from it by
#     `torch_bench_history.py --write-baseline`) — a baselined fade
#     passes, any NEW regression past 15% (or a known one deepening)
#     fails;
#   - `torch_static_audit --level deep` (raft_tpu_torch/analysis/cli.py):
#     the engine contracts, the byte model, the lint, the model
#     checker's smoke with its canary mutant, and the stream-ordering
#     hazard prover with its negatives.
#
# No card and no environment variable needed; rc != 0 names the
# regression or the violated contract. Run before pushing:
#
#   scripts/torch_ci_static.sh
set -euo pipefail
cd "$(dirname "$0")/.."
python scripts/torch_bench_history.py \
    --manifest scripts/torch_bench_manifest.jsonl \
    --check --threshold 0.15 --baseline scripts/torch_bench_baseline.json \
    >/dev/null
exec python scripts/torch_static_audit.py --level deep "$@"
