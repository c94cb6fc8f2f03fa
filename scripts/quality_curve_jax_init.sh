#!/bin/bash
# The port's full-width quality curve from JAX's own init, on one CUDA card.
#
#   bash scripts/quality_curve_jax_init.sh OUT_DIR STOP_AT RUN...
#
# Each RUN is jax:SEED (the params of
# nerfies_tpu_torch/curves/init/quality_init_jax_key0.npz, JAX's PRNGKey(0)
# tree of scripts/quality_bench.py, with the steps' draws of --seed SEED) or
# own:SEED (the port's own init of --seed SEED). The runs go side by side on
# the card, each on the schedules of JAX's 20,000-step run to STOP_AT
# (6000), 24 train frames of 384x288, batch 6144, the fused kernels, an eval
# every 500 steps; their step times are therefore not a card's alone. Each
# curve is OUT_DIR/quality_curve_h100_<jax_init|own_init>_seed<SEED>.json.
# Then scripts/compare_quality_curves.py holds each curve to
# docs/quality_curve.json and to the port's four committed 6,000-step seeds,
# and the runs' set to the reference. Two runs side by side take about 36
# minutes on an H100.
set -u
OUT=$1
STOP_AT=$2
shift 2
REF=docs/quality_curve.json
CURVES=nerfies_tpu_torch/curves
INIT=$CURVES/init/quality_init_jax_key0.npz
PORT_SEEDS="$CURVES/quality_curve_h100.json $CURVES/quality_curve_h100_fused_seed1.json $CURVES/quality_curve_h100_fused_seed3.json $CURVES/quality_curve_h100_fused_seed4.json"
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
# The scene once, before the runs start side by side.
python3 - "$WORK/scene" << 'PY' || exit 1
import sys
from nerfies_tpu_torch import quality_bench
quality_bench.write_scene(quality_bench.parse_args(['--scene_dir', sys.argv[1]]))
PY
names=()
for spec in "$@"; do
  kind=${spec%%:*}
  seed=${spec#*:}
  case $kind in
    jax) name=jax_init_seed$seed; extra=(--init_npz "$INIT") ;;
    own) name=own_init_seed$seed; extra=() ;;
    *) echo "unknown run $spec" >&2; exit 2 ;;
  esac
  names+=("$name")
  (python3 -m nerfies_tpu_torch.quality_bench --steps 20000 \
     --stop_at "$STOP_AT" --eval_every 500 --seed "$seed" \
     --scene_dir "$WORK/scene" --work_dir "$WORK/$name" \
     --out "$OUT/quality_curve_h100_$name.json" "${extra[@]}" \
     > "$OUT/$name.log" 2>&1
   echo "$name exited $?" >> "$OUT/$name.log") &
done
wait
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
curves=()
for name in "${names[@]}"; do
  curve=$OUT/quality_curve_h100_$name.json
  curves+=("$curve")
  echo "== $name"
  tail -n 4 "$OUT/$name.log"
  grep -q "$name exited 0" "$OUT/$name.log" || rc=1
  echo "-- against $REF"
  python3 scripts/compare_quality_curves.py "$REF" "$curve" \
    --steps $(seq 2000 2000 "$STOP_AT")
  echo "-- against the port's four seeds"
  python3 scripts/compare_quality_curves.py --spread $PORT_SEEDS \
    --against "$curve"
done
echo "== the runs against $REF"
python3 scripts/compare_quality_curves.py --spread "$REF" \
  --against "${curves[@]}"
exit "$rc"
