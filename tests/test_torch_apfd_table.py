"""The port's APFD table (``plotters/eval_apfd_table.py``, no pandas) against
the JAX package's on one set of artifacts: a mini study of two runs of two
families, written by the port's ``evaluate`` on the CPU (MNIST and IMDB at
the slice test's sizes, SA at each family's narrow tap). The run-averaged
APFD of every (approach, case study, dataset) and every time string must be
equal, float for float, to ``_get_as_df`` plus ``_add_reported_times`` on
the same ``TIP_ASSETS``.
"""

import csv
import math

import numpy as np
import pytest

from simple_tip_tpu.plotters import eval_apfd_table as jax_table
from simple_tip_tpu.plotters import times_collector as jax_times
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.plotters import eval_apfd_table, times_collector
from simple_tip_tpu_torch.plotters.utils import APPROACHES
from test_torch_model import flax_params
from test_torch_slice import FAMILIES, SA_TAPS, _data
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_transformer import imdb_flax_params

STUDY = ("mnist", "imdb")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A ``TIP_ASSETS`` with runs 0 and 1 of both families."""
    root = tmp_path_factory.mktemp("apfd_study")
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setenv("TIP_ASSETS", str(root))
        for family in STUDY:
            _, port_model, make_params, nc_layers, _, badge = FAMILIES[family][:6]
            x_train, x_test, y_test, x_ood = _data(family)
            for run in (0, 1):
                params = make_params() if run == 0 else _other_params(family)
                eval_prioritization.evaluate(
                    model_id=run, case_study=family, model_def=port_model(),
                    params=params_from_jax(params), training_dataset=x_train,
                    nominal_test_dataset=x_test, nominal_test_labels=y_test,
                    ood_test_dataset=x_ood, ood_test_labels=y_test,
                    nc_activation_layers=nc_layers[-1:],
                    sa_activation_layers=SA_TAPS[family][0], dsa_badge_size=badge,
                    batch_size=128, device="cpu",
                )
    return str(root)


def _other_params(family: str):
    return flax_params(9) if family == "mnist" else imdb_flax_params(9)


def test_port_table_equals_the_jax_table(assets, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", assets)
    want = jax_table._get_as_df(list(STUDY))
    jax_table._add_reported_times(want, jax_times.load_times())
    got = eval_apfd_table.run(list(STUDY))
    assert [approach for _, approach in got] == APPROACHES
    for row, cells in got.items():
        for cs in STUDY:
            for ds in ("nominal", "ood"):
                value = cells[cs, ds]
                assert value == want.loc[row, (cs, ds)], (row, cs, ds)
                assert isinstance(value, float), (row, cs, ds)  # all 39 approaches written
            time = want.loc[row, (cs, "time")]
            assert cells[cs, "time"] == (None if isinstance(time, float) and math.isnan(time)
                                         else time), (row, cs)
            assert cells[cs, "time"] is not None


def test_apfds_csv_holds_the_table(assets, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", assets)
    table = eval_apfd_table.run(list(STUDY))
    with open(f"{assets}/results/apfds.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][2:] == [cs for cs in STUDY for _ in range(3)]
    assert rows[1] == ["category", "approach"] + ["nominal", "ood", "time"] * 2
    assert len(rows) == 2 + len(APPROACHES)
    for line, ((cat, approach), cells) in zip(rows[2:], table.items()):
        assert line[:2] == [cat, approach]
        assert [float(line[2]), float(line[3]), line[4]] == [
            cells["mnist", "nominal"], cells["mnist", "ood"], cells["mnist", "time"]]


def test_times_are_read_like_the_jax_reader(assets, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", assets)
    got, want = times_collector.load_times(), jax_times.load_times()
    assert got == want and len(got) == 2 * 2 * 2 * (5 + 12 + 5)
    assert np.all([len(v) == 4 for v in got.values()])
