"""Quickstart on the PyTorch/CUDA port: the EnFed protocol end to end.

A resource-constrained device (requester) builds an HAR model by asking
5 nearby devices for their (AES-encrypted) model updates against an
incentive, aggregating them, and personalizing on its own data —
Algorithm 1 of the paper — then reports accuracy, training time, energy,
and remaining battery.  The twin of ``examples/quickstart.py`` on
``repro_torch``: it runs on the GPU, or on the host with ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

from repro_torch.core import EnFedConfig, EnFedSession, SupervisedTask, make_fleet
from repro_torch.data import HARDatasetConfig, dirichlet_partition, make_har_windows
from repro_torch.models import LSTMClassifier, LSTMClassifierConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU, which must exist)")
    device = ap.parse_args(argv).device

    # synthetic HARSense-like dataset (accelerometer+gyro, 6 activities)
    x, y, _user = make_har_windows(HARDatasetConfig(num_samples=3000, seq_len=32))
    parts = dirichlet_partition(y, num_clients=6, alpha=1.0, seed=0)
    shards = [(x[p], y[p]) for p in parts]

    # requester (device M) keeps shard 0; 80/20 split for personalization
    own_x, own_y = shards[0]
    n_train = int(len(own_x) * 0.8)
    own_train = (own_x[:n_train], own_y[:n_train])
    own_test = (own_x[n_train:], own_y[n_train:])

    task = SupervisedTask(
        LSTMClassifier(LSTMClassifierConfig(input_dim=6, seq_len=32,
                                            hidden=64, num_classes=6), device=device),
        lr=3e-3)

    # nearby devices: each pre-trains a local model on its own shard
    fleet = make_fleet(5, seed=1, p_has_model=1.0)
    contributor_states = {}
    for i, dev in enumerate(fleet):
        dev.reservation_price = 0.4        # all will accept a 0.6 incentive
        params = task.init(seed=10 + i)
        params, _ = task.fit(params, shards[i + 1], epochs=6, batch_size=32, seed=i)
        contributor_states[dev.device_id] = {"params": params, "data": shards[i + 1]}

    session = EnFedSession(
        task, own_train, own_test, fleet, contributor_states,
        EnFedConfig(desired_accuracy=0.95, max_rounds=10, n_max=5,
                    battery_threshold=0.2, offered_incentive=0.6,
                    epochs=8, batch_size=32, encrypt=True),
        device=task.device)
    res = session.run()

    print(f"device          : {task.device}")
    print(f"accuracy        : {res.accuracy:.3f} (target 0.95, stop: {res.stop_reason})")
    print(f"rounds          : {res.rounds} with {res.n_contributors} contributors")
    print(f"training time   : {res.report.t_train:.2f} s   (eq. 4)")
    print(f"energy consumed : {res.report.e_tot:.2f} J   (eqs. 5-7: "
          f"{res.report.e_comp:.2f} comp + {res.report.e_comm:.2f} comm)")
    print(f"battery left    : {res.battery.percent:.1f} %")
    return 0 if res.accuracy >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main())
