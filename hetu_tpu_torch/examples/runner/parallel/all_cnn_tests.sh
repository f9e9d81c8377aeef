#!/bin/bash
# CNN parity sweep (reference parity: all_cnn_tests.sh): the conv model
# under every dispatch split must reproduce the single-device base loss
# series. Each config is one worker process of the port's launcher.
set -e
cd "$(dirname "$0")"
ROOT="$(cd ../../../.. && pwd)"
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
RUN="python -m hetu_tpu_torch.launcher"
mkdir -p results

$RUN -c config1.yml python test_cnn_base.py --save --log results/base.npy

$RUN -c config2.yml python test_cnn_mp.py --split left   --log results/res0.npy
$RUN -c config2.yml python test_cnn_mp.py --split middle --log results/res1.npy
$RUN -c config2.yml python test_cnn_mp.py --split right  --log results/res2.npy

python validate_results.py 3
echo "all CNN parallel configs match the base loss series"
