"""The port's overhead tool, on the CPU, where only its mechanics can be
checked (as ``tests/test_bench.py`` checks the JAX tool's): every row
present, the single-pair rows refusing a confidence interval, the
interval's order statistics, the bare run."""

import json

from sofa_tpu_torch.tools import overhead_budget as budget


def test_entry_workload_is_the_flagship_forward():
    out = budget.make_workload("entry", "cpu")()
    assert out.shape == (4, 512, 8192)


def test_budget_runs_every_row_on_the_cpu(tmp_path):
    table, rows = budget.run_budget("resnet", steps=1, reps=1, max_reps=1,
                                    device="cpu")
    names = [r["name"] for r in rows]
    assert names[0] == "bare (no collectors)" and "baseline" in table
    assert "Kineto trace (shapes, flops)" in names
    assert "gpumon @ 1 Hz, no memprof" in names
    assert "whole api.profile()" in names
    sweep = [n for n in names if "memprof enabled=" in n]
    assert len(sweep) == len(budget.MEMPROF_SWEEP) == 9
    assert "gpumon @ 1 Hz + memprof enabled=state context=state " \
        "stacks=python" in sweep
    # one pair is too few for a 95 % interval: no row pretends to one
    assert "[95% CI" not in table
    assert table.count("too few for a 95% CI") == len(rows) - 1
    assert "not a measurement of the card" in table
    assert all(r["median_s"] > 0 for r in rows)


def test_budget_main_writes_the_table_and_rows(tmp_path, capsys):
    out, js = tmp_path / "t.md", tmp_path / "rows.json"
    assert budget.main(["--device", "cpu", "--workload", "resnet",
                        "--steps", "1", "--reps", "1", "--max_reps", "1",
                        "--out", str(out), "--json", str(js)]) == 0
    rows = json.loads(js.read_text())
    assert rows[0]["name"] == "bare (no collectors)" and len(rows) == 13
    assert len(rows[0]["bare_s"]) == 12
    # the bare runs before any collector and after the last, and each
    # row's own pairs' bare median
    assert len(rows[0]["clean_s"]) == len(rows[0]["untraced_s"]) \
        == len(rows[0]["after_s"]) == 3
    assert "before the first traced row" in rows[0]["note"]
    assert "after the last" in rows[0]["note"]
    # the rows with the trace come last
    assert [r["name"] for r in rows[-2:]] == [
        "Kineto trace (shapes, flops)", "whole api.profile()"]
    assert all(r["bare_median_s"] > 0 for r in rows)
    assert all(len(r["margins_pct"]) == 1 for r in rows[1:])
    assert out.read_text() in capsys.readouterr().out


def test_median_ci_order_statistics():
    assert budget._median_ci([1.0]) is None
    assert budget._median_ci([1.0, 2.0, 3.0, 4.0, 5.0]) is None
    lo, hi = budget._median_ci(list(range(20)))
    assert lo <= 9.5 <= hi and 0 < hi - lo < 19
    lo2, hi2 = budget._median_ci([x / 5 for x in range(100)])
    assert (hi2 - lo2) < (hi - lo)
    assert budget._median([3.0, 1.0, 2.0]) == 2.0
