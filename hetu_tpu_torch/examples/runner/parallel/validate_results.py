"""Assert every results/res{i}.npy matches results/base.npy (reference
examples/runner/parallel/validate_results.py — the zoo's parity gate).

    python validate_results.py 3 --rtol 1e-4
"""
import argparse
import os.path as osp

import numpy as np

if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("number", type=int,
                        help="how many results/res{i}.npy to check")
    parser.add_argument("--rtol", type=float, default=1e-4)
    parser.add_argument("--dir", default="results")
    args = parser.parse_args()

    base = np.load(osp.join(args.dir, "base.npy"))
    print("Ground truth:", base)
    for i in range(args.number):
        res = np.load(osp.join(args.dir, f"res{i}.npy"))
        np.testing.assert_allclose(base, res, rtol=args.rtol, atol=1e-6)
        print(f"Result id {i} passed test.", res)
