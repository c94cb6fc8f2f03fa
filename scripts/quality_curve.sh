#!/bin/bash
# Trains the port's quality curve on one CUDA card, holds it to JAX's curve
# and serves its params in the four serving modes.
#
#   bash scripts/quality_curve.sh OUT_DIR [STOP_AT]
#
# The run keeps the schedules of JAX's 20,000-step run and stops at STOP_AT
# (6000), as docs/quality_curve.json does: evals every 2,000 steps, 24
# train frames of 384x288, batch 6144, the fused kernels. It writes
# OUT_DIR/quality_curve_h100.json (the curve, the card and its power limit),
# OUT_DIR/quality_params.npz and OUT_DIR/serve_quality.json, and prints
# scripts/compare_quality_curves.py's table. Where a row misses the bar it
# also trains the plain forward (--no-fused) to 2,000 steps into
# OUT_DIR/quality_curve_h100_plain.json and compares that with both. Exits
# with the comparison's code. About 25 minutes on an H100; 45 with the
# plain run.
set -u
OUT=$1
STOP_AT=${2:-6000}
REF=docs/quality_curve.json
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -m nerfies_tpu_torch.quality_bench --steps 20000 \
  --stop_at "$STOP_AT" --eval_every 2000 --scene_dir "$WORK/scene" \
  --work_dir "$WORK/fused" --out "$OUT/quality_curve_h100.json" \
  --save_params "$OUT/quality_params.npz" || exit 1
python3 -m nerfies_tpu_torch.serve_bench --params "$OUT/quality_params.npz" \
  --scene_dir "$WORK/scene" --out "$OUT/serve_quality.json" || exit 1
python3 scripts/compare_quality_curves.py "$REF" \
  "$OUT/quality_curve_h100.json" --steps $(seq 2000 2000 "$STOP_AT")
rc=$?
if [ "$rc" -ne 0 ]; then
  python3 -m nerfies_tpu_torch.quality_bench --steps 20000 --stop_at 2000 \
    --eval_every 2000 --no-fused --scene_dir "$WORK/scene" \
    --work_dir "$WORK/plain" --out "$OUT/quality_curve_h100_plain.json" \
    || exit 1
  echo 'plain route against the reference:'
  python3 scripts/compare_quality_curves.py "$REF" \
    "$OUT/quality_curve_h100_plain.json" --steps 2000
  echo 'fused route against the plain route:'
  python3 scripts/compare_quality_curves.py \
    "$OUT/quality_curve_h100_plain.json" "$OUT/quality_curve_h100.json" \
    --steps 2000
fi
exit "$rc"
