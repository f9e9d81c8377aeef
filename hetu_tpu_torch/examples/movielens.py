"""MovieLens data for NCF: the port's own copy of
``examples/rec/movielens.py`` (reference parity: examples/rec/movielens.py).

Produces the reference preprocessor's artifacts: a train set of
``(user_input, item_input, labels)`` with ``num_negatives`` sampled
negatives per positive, and a leave-latest-out test matrix ``[num_users,
100]`` whose column 0 is the held-out positive item and columns 1..99
are sampled negatives (movielens.py:66-104).

Nothing is downloaded. In order, :func:`getdata` loads a preprocessed
``train.npz`` + ``test.npy``; preprocesses a ``ratings.csv`` /
``ratings.dat`` already on disk; else synthesizes an implicit-feedback
set with planted block structure, so HR@10 is a meaningful signal (a
trained model must beat the 10/100 random baseline by a wide margin).
"""
from __future__ import annotations

import os

import numpy as np

from ..data import _data_dir

CARDINALITIES = {
    "ml-1m": (6040, 3706),
    "ml-20m": (138493, 26744),
    "ml-25m": (162541, 59047),
}


def _preprocess_ratings(path, num_users=None, num_items=None,
                        num_negatives=4, seed=0):
    """ratings.csv/.dat -> (train dict, test matrix), the reference's
    leave-latest-out protocol (movielens.py:42-104). Cardinalities are
    inferred from the file when not given (custom dataset dirs)."""
    rng = np.random.RandomState(seed)
    sep = "::" if path.endswith(".dat") else ","
    item_map, next_item = {}, 0
    seen = set()
    latest = {}
    max_user = -1
    with open(path, "r") as fr:
        first = fr.readline()
        if not first or first[0].isdigit():     # .dat has no header
            fr.seek(0)
        for line in fr:
            e = line.strip().split(sep)
            user, item, rating, ts = (int(e[0]) - 1, int(e[1]),
                                      float(e[2]), int(e[-1]))
            if rating <= 0:
                continue
            if item not in item_map:
                item_map[item] = next_item
                next_item += 1
            reitem = item_map[item]
            seen.add((user, reitem))
            max_user = max(max_user, user)
            if user not in latest or latest[user][0] < ts:
                latest[user] = (ts, reitem)
    if num_users is None:
        num_users = max_user + 1
    if num_items is None:
        num_items = next_item

    test = np.zeros((num_users, 100), dtype=np.int32)
    for u in range(num_users):
        test[u, 0] = latest.get(u, (0, 0))[1]
        for k in range(1, 100):
            j = rng.randint(num_items)
            while (u, j) in seen:
                j = rng.randint(num_items)
            test[u, k] = j

    pos = [(u, i) for (u, i) in seen if latest.get(u, (0, -1))[1] != i]
    n = (1 + num_negatives) * len(pos)
    user_input = np.empty(n, dtype=np.int32)
    item_input = np.empty(n, dtype=np.int32)
    labels = np.empty(n, dtype=np.int32)
    idx = 0
    for (u, i) in pos:
        user_input[idx], item_input[idx], labels[idx] = u, i, 1
        idx += 1
        for _ in range(num_negatives):
            k = rng.randint(num_items)
            while (u, k) in seen:
                k = rng.randint(num_items)
            user_input[idx], item_input[idx], labels[idx] = u, k, 0
            idx += 1
    train = {"user_input": user_input, "item_input": item_input,
             "labels": labels}
    return train, test, num_users, num_items


def make_synthetic(num_users=800, num_items=600, num_negatives=4,
                   interactions_per_user=40, nclusters=6, seed=0):
    """Implicit feedback with planted co-clusters: user u's positives
    come from item cluster u%nclusters (plus noise), so embeddings can
    learn the structure and HR@10 climbs well above the 0.1 random
    floor."""
    rng = np.random.RandomState(seed)
    item_cluster = rng.randint(0, nclusters, num_items)
    cluster_items = [np.nonzero(item_cluster == c)[0]
                     for c in range(nclusters)]
    seen = set()
    users, items = [], []
    held = {}
    for u in range(num_users):
        mine = cluster_items[u % nclusters]
        k = min(interactions_per_user, len(mine))
        picks = rng.choice(mine, size=k, replace=False)
        # hold out an IN-CLUSTER positive: the model can only rank it
        # from the cluster structure it learned off the other positives
        held[u] = int(picks[0])
        # a little cross-cluster noise keeps it from being separable
        noise = rng.randint(0, num_items, max(1, k // 8))
        for i in np.concatenate([picks, noise]):
            if (u, int(i)) not in seen:
                seen.add((u, int(i)))
                users.append(u)
                items.append(int(i))

    test = np.zeros((num_users, 100), dtype=np.int32)
    for u in range(num_users):
        test[u, 0] = held[u]
        negs = rng.randint(0, num_items, 99)
        for k in range(99):
            while (u, int(negs[k])) in seen:
                negs[k] = rng.randint(num_items)
        test[u, 1:] = negs

    user_input, item_input, labels = [], [], []
    for u, i in zip(users, items):
        if i == held[u]:
            continue
        user_input.append(u)
        item_input.append(i)
        labels.append(1)
        for _ in range(num_negatives):
            k = rng.randint(num_items)
            while (u, k) in seen:
                k = rng.randint(num_items)
            user_input.append(u)
            item_input.append(k)
            labels.append(0)
    order = rng.permutation(len(labels))
    train = {"user_input": np.asarray(user_input, np.int32)[order],
             "item_input": np.asarray(item_input, np.int32)[order],
             "labels": np.asarray(labels, np.int32)[order]}
    return train, test, num_users, num_items


def getdata(dataset="ml-25m", data_dir=None):
    """(train dict, test matrix, num_users, num_items)."""
    data_dir = data_dir or _data_dir()
    sub = os.path.join(data_dir, dataset)
    train_p = os.path.join(sub, "train.npz")
    test_p = os.path.join(sub, "test.npy")
    num_users, num_items = CARDINALITIES.get(dataset, (None, None))
    if os.path.exists(train_p) and os.path.exists(test_p):
        return (dict(np.load(train_p)), np.load(test_p),
                num_users, num_items)
    for name in ("ratings.csv", "ratings.dat"):
        p = os.path.join(sub, name)
        if os.path.exists(p):
            train, test, num_users, num_items = _preprocess_ratings(
                p, num_users, num_items)
            os.makedirs(sub, exist_ok=True)
            np.savez(train_p, **train)
            np.save(test_p, test)
            return train, test, num_users, num_items
    print(f"[movielens] {sub} not found - synthesizing implicit-feedback "
          "data (set HETU_DATA_DIR to use the real dataset)", flush=True)
    return make_synthetic()
