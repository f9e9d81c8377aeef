#!/bin/bash
# The zoo's parity sweep (reference parity: all_mlp_tests.sh): the base
# run is ground truth; every parallel config must reproduce its loss
# series. Each config is one worker process of the port's launcher; its
# devices are the card's where CUDA is available, else the CPU's.
set -e
cd "$(dirname "$0")"
ROOT="$(cd ../../../.. && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
RUN="python -m hetu_tpu_torch.launcher"
mkdir -p results

$RUN -c config1.yml python test_mlp_base.py --save --log results/base.npy

$RUN -c config2.yml python test_mlp_pp.py --log results/res0.npy

$RUN -c config2.yml python test_mlp_mp.py --split left   --log results/res1.npy
$RUN -c config2.yml python test_mlp_mp.py --split middle --log results/res2.npy
$RUN -c config2.yml python test_mlp_mp.py --split right  --log results/res3.npy
$RUN -c config4.yml python test_mlp_mp.py --split 0      --log results/res4.npy
$RUN -c config4.yml python test_mlp_mp.py --split 1      --log results/res5.npy
$RUN -c config4.yml python test_mlp_mp.py --split 2      --log results/res6.npy
$RUN -c config4.yml python test_mlp_mp.py --split 3      --log results/res7.npy
$RUN -c config4.yml python test_mlp_mp.py --split 4      --log results/res8.npy

$RUN -c config4.yml python test_mlp_mp_pp.py --split left   --log results/res9.npy
$RUN -c config4.yml python test_mlp_mp_pp.py --split middle --log results/res10.npy
$RUN -c config4.yml python test_mlp_mp_pp.py --split right  --log results/res11.npy
$RUN -c config8.yml python test_mlp_mp_pp.py --split 1      --log results/res12.npy

$RUN -c dist_config2.yml python dist_data_mlp.py --log results/res13.npy

python validate_results.py 14
echo "all parallel configs match the base loss series"
