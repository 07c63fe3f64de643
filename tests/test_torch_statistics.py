"""The port's statistics evaluations and paper tables against the JAX
package's, on the CPU.

- ``paired_vargha_delaney_a12`` and ``wilcoxon_p`` equal the JAX functions
  on seeded vectors with ties and on all-equal pairs (NaN where scipy
  refuses, as it does for 1 and for 40 equal values).
- ``WilcoxonCorrelationPlot.calc_values``: the p, effect-size and
  sample-count grids equal the JAX package's, NaNs in the same places, on
  seeded pooled data of 39 approaches x 12 runs with runs missing.
- On one synthetic asset tree (three case studies, a run past 100, runs
  and approaches missing, ties in the scores): the two correlation CSVs
  and the two LaTeX tables are byte-equal to what the JAX package writes
  (``DataFrame.to_csv`` and ``to_latex``); the CLI's two statistics
  evaluations exit 0 and write the same bytes.
"""

import os
import pickle
import warnings

import numpy as np
import pytest

from simple_tip_tpu.plotters import correlation_plot as jax_corr
from simple_tip_tpu.plotters import eval_active_correlation as jax_active_corr
from simple_tip_tpu.plotters import eval_active_learning_table as jax_al_table
from simple_tip_tpu.plotters import eval_apfd_correlation as jax_apfd_corr
from simple_tip_tpu.plotters import eval_apfd_table as jax_apfd_table
from simple_tip_tpu.plotters import utils as jax_utils
from simple_tip_tpu_torch import cli
from simple_tip_tpu_torch.plotters import correlation_plot as corr
from simple_tip_tpu_torch.plotters import (
    eval_active_correlation,
    eval_active_learning_table,
    eval_apfd_correlation,
    eval_apfd_table,
    utils,
)
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

STUDIES = ("mnist", "cifar10", "imdb")
UNCERTAINTY = ("deep_gini", "softmax", "pcs", "softmax_entropy", "VR")
ROWS = 30


def _vectors(seed: int, n: int, case: str):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 6, n).astype(float) / 5  # ties within and across
    if case == "equal":
        return list(x), list(x)
    if case == "shifted":
        return list(x), list(x + 0.2)
    return list(x), list(rng.integers(0, 6, n).astype(float) / 5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", ["ties", "equal", "shifted"])
@pytest.mark.parametrize("n", [1, 7, 40])
def test_effect_size_and_p_equal_the_jax_functions(seed, case, n):
    x, y = _vectors(seed, n, case)
    assert corr.paired_vargha_delaney_a12(x, y) == jax_corr.paired_vargha_delaney_a12(x, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = jax_corr.wilcoxon_p(x, y), corr.wilcoxon_p(x, y)
    assert got == want or (np.isnan(got) and np.isnan(want))


def _pooled(seed: int):
    """39 approaches x 12 runs of three studies, runs missing and ties
    (pairs share 20 to 36 samples: scipy's exact test with ties, which it
    takes below about 14, costs a second a pair)."""
    rng = np.random.default_rng(seed)
    pooled = {a: {} for a in utils.APPROACHES}
    for a in utils.APPROACHES:
        for cs in STUDIES:
            for run in range(12):
                if rng.random() < 0.1:
                    continue
                pooled[a][f"{cs}_{run}"] = float(rng.integers(0, 20)) / 20
    pooled["VR"] = {}
    pooled["dsa"] = dict(pooled["dsa-cam"])
    return pooled


@pytest.mark.parametrize("seed", [0, 1])
def test_grids_equal_the_jax_grids(seed):
    grids = []
    for module in (corr, jax_corr):
        grid = module.WilcoxonCorrelationPlot(utils.APPROACHES, num_tested_approaches=39)
        for approach, samples in _pooled(seed).items():
            for sample, value in samples.items():
                grid.add_measurement(approach, sample, value)
        grid.add_measurement("not an approach", "mnist_0", 1.0)
        assert grid.bonferroni_factor == 741
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            grids.append(grid.calc_values())
    got, want = grids
    assert set(got) == set(want) == {"p", "e", "num_samples"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert np.isnan(got["p"]).any() and (got["p"] == corr.P_UNTESTED).any()
    # equal value lists (dsa and its CAM form here) are NaN, never tested
    i, j = utils.APPROACHES.index("dsa-cam"), utils.APPROACHES.index("dsa")
    assert np.isnan(got["p"][i, j]) and np.isnan(got["e"][i, j])


def test_a_duplicate_sample_is_refused():
    grid = corr.WilcoxonCorrelationPlot(["dsa", "pc-lsa"], 39)
    grid.add_measurement("dsa", "mnist_0", 0.5)
    with pytest.raises(AssertionError, match="unique"):
        grid.add_measurement("dsa", "mnist_0", 0.6)
    grid.add_measurement("dsa", "mnist_0", 0.6, unique=False)
    assert grid.measurements["dsa"] == {"mnist_0": 0.6}


# -- one synthetic asset tree through both packages --------------------------------


def _write_bus(root):
    rng = np.random.default_rng(11)
    for sub in ("priorities", "times", "active_learning"):
        os.makedirs(root / sub)
    splits = [(s, p) for s in ("nominal", "ood") for p in ("observed", "future")]
    for cs, runs, dropout in (("mnist", [*range(12), 100], True), ("cifar10", range(12), False),
                              ("imdb", range(3), True)):
        for run in runs:
            skipped = set(rng.choice(utils.APPROACHES, 2, replace=False)) if run % 4 == 1 else set()
            if not dropout:
                skipped.add("VR")
            for ds in ("nominal", "ood"):
                mask = rng.random(ROWS) < 0.3
                np.save(root / "priorities" / f"{cs}_{ds}_{run}_is_misclassified.npy", mask)
                for a in utils.APPROACHES:
                    if a in skipped:
                        continue
                    stem = root / "priorities" / f"{cs}_{ds}_{run}"
                    if a.endswith("-cam"):
                        np.save(f"{stem}_{a[:-4]}_cam_order.npy", rng.permutation(ROWS))
                    elif a in UNCERTAINTY:
                        np.save(f"{stem}_uncertainty_{a}.npy",
                                rng.integers(0, 4, ROWS).astype(np.float32))
                    else:
                        np.save(f"{stem}_{a}_scores.npy", rng.integers(0, 8, ROWS) / 8)
                    if run < 10:
                        metric = a[:-4] if a.endswith("-cam") else a
                        record = [float(v) for v in rng.random(4 if a not in UNCERTAINTY else 3)]
                        with open(root / "times" / f"{cs}_{ds}_{run}_{metric}", "wb") as f:
                            pickle.dump(record, f)
            entries = [("original", "na")] + [
                (a, obs) for a in [*utils.APPROACHES, "random"] if a not in skipped
                for obs in ("nominal", "ood")]
            for approach, obs in entries:
                acc = {s: float(rng.integers(0, 40)) / 40 for s in splits}
                with open(root / "active_learning" / f"{cs}_{run}_{approach}_{obs}.pickle",
                          "wb") as f:
                    pickle.dump(acc, f)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """{file name: (JAX bytes, port bytes)} of the four result files."""
    jax_root, port_root = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("port")
    out = {}
    with pytest.MonkeyPatch.context() as monkeypatch, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for root, runs in (
            (jax_root, (jax_apfd_table.run, jax_al_table.run,
                        lambda cs: jax_apfd_corr.run(cs, plot=False),
                        lambda cs: jax_active_corr.run(cs, plot=False))),
            (port_root, (eval_apfd_table.run, eval_active_learning_table.run,
                         eval_apfd_correlation.run, eval_active_correlation.run)),
        ):
            _write_bus(root)
            monkeypatch.setenv("TIP_ASSETS", str(root))
            jax_utils._ARTIFACT_MEMO.clear()
            for run in runs:
                run(list(STUDIES))
        for name in sorted(os.listdir(jax_root / "results")):
            out[name] = ((jax_root / "results" / name).read_bytes(),
                         (port_root / "results" / name).read_bytes())
    return out


@pytest.mark.parametrize("name", ["apfd_correlation_p.csv", "apfd_correlation_eff.csv",
                                  "active_correlation_p.csv", "active_correlation_eff.csv",
                                  "apfd_paper_table.tex", "active_paper_table.tex"])
def test_result_files_are_byte_equal_to_the_jax_files(written, name):
    want, got = written[name]
    assert got == want
    assert len(want) > 1000


def test_the_grids_have_the_human_labels(written):
    want, _ = written["apfd_correlation_p.csv"]
    rows = want.decode().splitlines()
    assert len(rows) == 40
    assert rows[0].split(",") == ["", *utils.human_approach_names(utils.APPROACHES)]
    assert rows[0].split(",")[1:3] == ["NAC-0.75-CAM", "NAC-0.75"]
    assert rows[1].split(",")[1] == ""  # the untested diagonal is blank


@pytest.mark.parametrize("which, prefix", [("test_prio_statistics", "apfd_correlation"),
                                           ("active_learning_statistics",
                                            "active_correlation")])
def test_the_cli_writes_the_statistics(written, tmp_path, monkeypatch, which, prefix):
    _write_bus(tmp_path)
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    module = {"apfd_correlation": eval_apfd_correlation,
              "active_correlation": eval_active_correlation}[prefix]
    real = module.run  # the registry's four studies, cut to the bus's three
    monkeypatch.setattr(module, "run", lambda case_studies: real(list(STUDIES)))
    assert cli.main(["--phase", "evaluation", "--eval", which]) == 0
    for suffix in ("p", "eff"):
        name = f"{prefix}_{suffix}.csv"
        assert (tmp_path / "results" / name).read_bytes() == written[name][0]


def test_the_heatmap_is_not_ported():
    with pytest.raises(NotImplementedError, match="heatmap"):
        eval_apfd_correlation.run(STUDIES, plot=True)
