#!/bin/bash
# The spread behind a quality curve on one CUDA card, and what each render
# route costs on a fit.
#
#   bash scripts/quality_curve_spread.sh OUT_DIR PARAMS_NPZ [STOP_AT]
#
# First scripts/render_routes.py on PARAMS_NPZ (a quality_bench fit of the
# default scene). Then three quality_bench runs side by side on the card,
# each on the schedules of JAX's 20,000-step run to STOP_AT (6000): the
# fused kernels under --seed 1 and --seed 2, and the plain forward
# (--no-fused) under seed 0. They share the card, so their step times are
# not a card's alone; their curves are what this reads. Each curve,
# OUT_DIR/quality_curve_h100_<run>.json, is then compared with
# docs/quality_curve.json. On an H100 the three time-slice the card at
# about 0.6 s a step each: 4,000 steps take about 42 minutes, 6,000 about
# 62, so give STOP_AT 4000 to a 3,600 s call.
set -u
OUT=$1
PARAMS=$2
STOP_AT=${3:-6000}
REF=docs/quality_curve.json
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$OUT"
python3 scripts/render_routes.py --params "$PARAMS" \
  --scene_dir "$WORK/scene" || exit 1
run() {
  local name=$1
  shift
  python3 -m nerfies_tpu_torch.quality_bench --steps 20000 \
    --stop_at "$STOP_AT" --eval_every 2000 --scene_dir "$WORK/scene" \
    --work_dir "$WORK/$name" --out "$OUT/quality_curve_h100_$name.json" \
    "$@" > "$OUT/$name.log" 2>&1
  echo "$name exited $?" >> "$OUT/$name.log"
}
run fused_seed1 --seed 1 &
run fused_seed2 --seed 2 &
run plain --no-fused &
wait
rc=0
for name in fused_seed1 fused_seed2 plain; do
  echo "== $name"
  tail -n 6 "$OUT/$name.log"
  python3 scripts/compare_quality_curves.py "$REF" \
    "$OUT/quality_curve_h100_$name.json" \
    --steps $(seq 2000 2000 "$STOP_AT") || rc=1
done
exit "$rc"
