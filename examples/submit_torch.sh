#!/bin/bash
# SLURM array-job submission for replica fan-out on the PyTorch/CUDA port
# (parity: the reference's submit.sh: one replica per array task; the
# driver picks up SLURM_ARRAY_TASK_ID by itself). On one GPU, prefer
# batching the replicas into one state: --vmap-replicas --replicas 1-8
# runs them as one batch (each kernel once a step for all of them), and
# python -m torch.distributed.run --nproc-per-node R ... --shard-replicas R
# spreads that batch over R processes. Arguments after the coupling go
# to the driver and win over the ones below (for example --device CPU
# --runtime 0.004 for a short run on the CPU).
#SBATCH --job-name=cavmd
#SBATCH --array=0-499
#SBATCH --ntasks=1
#SBATCH --cpus-per-task=1
#SBATCH --gres=gpu:1
#SBATCH --time=24:00:00

COUPLING=${1:-1e-3}
[ $# -gt 0 ] && shift

python -m cavmd_tpu_torch.drivers.advanced_run \
    --molecular-bath bussi --cavity-bath langevin \
    --coupling "$COUPLING" --frequency 2000 --temperature 100 \
    --runtime 500 --enable-energy-tracker --enable-fkt "$@"
