"""The benchmark's frozen copy of the twin generator, bitwise the
port's, and its eval sets as the launcher takes them."""
import numpy as np

from portbench_tiny import ROOT  # noqa: F401  (puts the benchmark on the path)

from portbench import twin as twins


def test_frozen_twin_is_the_ports(tmp_path):
    from repro_torch.data import load_federated_dataset
    from repro_torch.launch.train import val_windows

    params = {"name": "replace-bg", "fast": True, "max_patients": 2, "history_len": 12,
              "horizon": 6}
    made, seconds = twins.load(params, tmp_path)
    loaded, again = twins.load(params, tmp_path)
    assert seconds is not None and again is None
    fed = load_federated_dataset("replace-bg", fast=True, max_patients=2)
    for t in (made, loaded):
        assert np.array_equal(t.x, fed.x) and np.array_equal(t.y, fed.y)
        assert np.array_equal(t.counts, fed.counts)
        assert (t.mean, t.sd) == (fed.mean, fed.sd)
        assert np.array_equal(t.val_x, np.concatenate([p.val_x for p in fed.patients]))
        vx, vy = t.val_set("launcher")
        want_x, want_y = val_windows(fed)
        assert np.array_equal(vx, want_x) and np.array_equal(vy, want_y)
