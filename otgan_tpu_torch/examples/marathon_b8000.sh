#!/usr/bin/env bash
# The batch-8000 crash-recovery rehearsal on one card (the port's
# counterpart of examples/marathon_b8000.sh): the reference's model-saving
# configuration (train_with_model_saving.py:16,23-24: global batch 8000,
# 3:1 G:D) through python -m otgan_tpu_torch.train with the JAX script's
# flags, --grad_accum 8 --remat, DCP step directories
# (--checkpoint_backend orbax), FID eval on fixed-seed random Inception
# weights, and two SIGKILLs: after the epoch-21 line, then after the
# epoch-41 line, then a last leg to epoch 60. Each kill waits for its epoch
# line, so each leg dies with steps running; with --save_every_epochs 10
# an asynchronous DCP write may be in flight when it lands.
#
# Usage: bash otgan_tpu_torch/examples/marathon_b8000.sh [RUN_DIR]
# (from the repository root; RUN_DIR defaults to runs/marathon_b8000).
# It prints every leg's "restored ..." line, the step directories (the
# committed ones marked), and every IS and FID line.
set -u
RUN_DIR="${1:-runs/marathon_b8000}"
LOG_DIR="$RUN_DIR/logs"
WEIGHTS="$RUN_DIR/inception_rw.npz"
mkdir -p "$RUN_DIR" "$LOG_DIR"

COMMON_FLAGS=(
  --preset model_saving --synthetic_data --synthetic_size 10000
  --grad_accum 8 --remat --checkpoint_backend orbax
  --save_dir "$RUN_DIR" --log_every_steps 1
  --eval_every_epochs 15 --eval_fid --inception_batch 500
  --save_every_epochs 10 --max_checkpoints_to_keep 3
  --keep_checkpoint_every_n_hours 0.2
  --max_epochs 60
)

export OTGAN_INCEPTION_WEIGHTS="$WEIGHTS"

log() { echo "[marathon $(date -u +%H:%M:%S)] $*"; }

if [ ! -f "$WEIGHTS" ]; then
  log "writing fixed-seed random classifier weights -> $WEIGHTS"
  python -u -m otgan_tpu_torch.eval.random_weights --out "$WEIGHTS" --seed 2024 || exit 1
fi

# wait_epoch LOGFILE N PID: block until the epoch-N record ("[step S]
# epoch=N.000000, ...") appears or the process exits
wait_epoch() {
  local logfile="$1" epoch="$2" pid="$3"
  while kill -0 "$pid" 2>/dev/null; do
    if grep -qE "\] epoch=${epoch}(\.0+)?," "$logfile" 2>/dev/null; then return 0; fi
    sleep 2
  done
  return 1  # the process exited on its own
}

# in_flight: the step directories that hold DCP files but no .metadata
in_flight() {
  local d
  for d in "$RUN_DIR"/orbax/*/; do
    [ -d "$d" ] || continue
    if [ ! -f "$d.metadata" ]; then printf '%s ' "$(basename "$d")"; fi
  done
}

run_leg() {
  local name="$1" kill_after_epoch="$2"; shift 2
  local logfile="$LOG_DIR/$name.log"
  local t0=$SECONDS
  log "leg $name starting (extra flags: $*) -> $logfile"
  python -u -m otgan_tpu_torch.train "${COMMON_FLAGS[@]}" "$@" \
    > "$logfile" 2>&1 &
  local pid=$!
  if [ "$kill_after_epoch" -ge 0 ]; then
    if wait_epoch "$logfile" "$kill_after_epoch" "$pid"; then
      local writing
      writing="$(in_flight)"
      kill -9 "$pid" 2>/dev/null
      wait "$pid" 2>/dev/null
      log "leg $name reached epoch $kill_after_epoch after $((SECONDS - t0)) s -> SIGKILL" \
          "$pid; uncommitted step directories at the kill: ${writing:-none}"
      return 0
    fi
    wait "$pid"; local rc=$?
    log "leg $name exited rc=$rc before epoch $kill_after_epoch"
    return $rc
  fi
  wait "$pid"; local rc=$?
  log "leg $name finished rc=$rc after $((SECONDS - t0)) s"
  return $rc
}

# leg 1: fresh start, dies after the first eval event (epoch 15) at epoch 21
run_leg leg1 21 || exit $?
# leg 2: resumes, dies after the second eval event (epoch 30) at epoch 41
run_leg leg2 41 --load_params || exit $?
# leg 3: resumes and runs to the end (epoch 60)
run_leg leg3 -1 --load_params
rc=$?

log "marathon complete rc=$rc"
echo "== restored (each leg)"
grep -H "restored \|no checkpoint found" "$LOG_DIR"/leg*.log
echo "== step directories (committed: .metadata present)"
for d in "$RUN_DIR"/orbax/*/; do
  [ -d "$d" ] || continue
  if [ -f "$d.metadata" ]; then state=committed; else state=uncommitted; fi
  echo "$(basename "$d") $state"
done
echo "== inception scores and FIDs"
grep -H "inception score was\|FID was" "$LOG_DIR"/leg*.log
exit $rc
