#!/usr/bin/env bash
# The port's multi-GPU check on one host with four GPUs, one process per GPU
# over NCCL: the multiproc cluster (global sum, sharded position PPO, the
# checkpoint barrier and restore, LiDAR-navigation PPO), then the README's
# torchrun commands at a few iterations each. Each step's log goes to
# LOG_DIR/<step>.log; the tails and one status line per step are printed.
#
#   bash scripts/torch_four_card_check.sh [NPROC] [LOG_DIR]
set -u
NPROC=${1:-4}
OUT=${2:-four_card_logs}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export NCCL_DEBUG=INFO
rc_all=0

run() {  # name, time limit (s), command...
    local name=$1 limit=$2
    shift 2
    local t0=$(date +%s.%N)
    timeout -k 10 "$limit" "$@" > "$OUT/$name.log" 2>&1
    local rc=$?
    local t1=$(date +%s.%N)
    echo "=== $name rc=$rc seconds=$(awk "BEGIN{print $t1 - $t0}")"
    grep -v "NCCL INFO" "$OUT/$name.log" | tail -n 25
    [ $rc -ne 0 ] && rc_all=1
}

run multiproc 420 python -m aerial_gym_simulator_tpu_torch.parallel.multiproc \
    --launch "$NPROC" --timeout 300
run ppo_nav 420 torchrun --nproc_per_node="$NPROC" -m aerial_gym_simulator_tpu_torch.rl.ppo \
    --multichip --task navigation_task --num_envs 4096 --horizon 32 --total_steps $((4096 * 32 * 4))
run bptt 300 torchrun --nproc_per_node="$NPROC" -m aerial_gym_simulator_tpu_torch.rl.bptt \
    --multichip --num_envs 1024 --iters 20
run population 420 torchrun --nproc_per_node="$NPROC" -m aerial_gym_simulator_tpu_torch.rl.population \
    --multichip --num_seeds 8 --env_devices 2 --num_envs 1024 --total_steps $((1024 * 32 * 2))
echo "four_card_check rc=$rc_all"
exit $rc_all
