#!/bin/bash
# The mesh on four cards over NCCL (ROADMAP A8b), from the repository root
# of a host with four cards:
#
#     bash chip_mesh4.sh
#
# 1. chip_smoke.py's phase 19 with its four ranks on four cards over NCCL
#    (the script itself runs them on one card over gloo): the same checks,
#    each rank on cuda:LOCAL_RANK.
# 2. Full-width smollm-135m, 10 steps of 8 x 1024 tokens, mcdla + fp8,
#    through the training CLI: one process on one card, then torchrun over
#    the four cards with NCCL, then with gloo (every collective staged
#    through pinned host memory).
# Outputs go to chiprun_out/mesh4/.
set -u
out=chiprun_out/mesh4
mkdir -p "$out" build
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())"
PYTHONPATH=src python -c "from repro_torch.kernels import build; build.build()" || exit 5
cat > build/mesh4_phase19.py <<'PY'
"""chip_smoke.py's phase 19 with its ranks on four cards over NCCL."""
import os
import sys
import torch
sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import chip_smoke as C
C.__file__ = os.path.abspath(__file__)
C.MESH_ARGS = ["nccl" if a == "gloo" else a for a in C.MESH_ARGS]
C.MESH_LOCAL_ARGS = ["nccl" if a == "gloo" else a for a in C.MESH_LOCAL_ARGS]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if sys.argv[1:2] == ["--mesh-rank"]:
    C.run_mesh_rank(sys.argv[2])
else:
    print(C.check_mesh_train())
PY
t0=$(date +%s)
timeout 900 python build/mesh4_phase19.py > "$out/phase19_nccl.out" 2>&1
echo "phase 19 over NCCL: rc=$? in $(( $(date +%s) - t0 )) s"
A="--arch smollm --device cuda --seed 0 --batch 8 --seq 1024 --steps 10 --lr 3e-4 --policy mcdla --compress fp8 --log-every 1"
CUDA_VISIBLE_DEVICES=0 PYTHONPATH=src timeout 300 python -m repro_torch.launch.train $A > "$out/one.out" 2>&1
echo "one process: rc=$?"
for run in nccl:29511 gloo:29512; do
  backend=${run%:*}
  PYTHONPATH=src timeout 300 python -m torch.distributed.run --nproc-per-node 4 \
    --master-port ${run#*:} -m repro_torch.launch.train $A --dist-backend $backend \
    > "$out/$backend.out" 2>&1
  echo "torchrun, $backend: rc=$?"
done
tail -c 6000 "$out/phase19_nccl.out"
for f in one nccl gloo; do echo "== $f"; grep -v -i "warn" "$out/$f.out" | tail -16; done
