"""Sweep -> wandb reporting (the port's copy of
:mod:`trlx_tpu.sweep.wandb_report`, after the reference's
``trlx/ray_tune/wandb.py``).

``log_trials`` replays trial records into wandb runs (`wandb.py:47-82`);
``create_report`` builds a programmatic W&B report — parallel coordinates,
parameter importance, per-metric scatter (`wandb.py:85-214`). Both are
no-ops when wandb isn't installed or is disabled.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List


def _wandb():
    if os.environ.get("WANDB_DISABLED", "") in ("1", "true"):
        return None
    try:
        import wandb

        return wandb
    except ImportError:
        return None


def log_trials(trials: List[Dict[str, Any]], tune_config: Dict[str, Any],
               project: str = "trlx_tpu_torch-sweeps") -> None:
    """One wandb run per trial, config = params, summary = final result.
    Trials carrying a ``history`` list (per-step stat dicts, the analogue of
    the reference's per-trial ``result.json`` rows, `ray_tune/wandb.py:47-82`)
    are replayed step by step so line plots have real curves."""
    wandb = _wandb()
    if wandb is None:
        return
    for i, trial in enumerate(trials):
        run = wandb.init(
            project=project,
            name=f"trial-{i}",
            config=trial["params"],
            reinit=True,
            mode=os.environ.get("WANDB_MODE", "offline"),
        )
        for row in trial.get("history", ()):
            run.log(row)
        run.log(trial["result"])
        run.finish()


def create_report(project: str, param_space: Dict[str, Any],
                  metric: str, trials: List[Dict[str, Any]],
                  best: Dict[str, Any]) -> None:
    """Programmatic W&B report (requires wandb + the report API)."""
    wandb = _wandb()
    if wandb is None:
        return
    try:
        import wandb.apis.reports as wb
    except Exception:
        return
    report = wb.Report(
        project=project,
        title=f"Sweep report: {metric}",
        description=f"best params: {best.get('params')}",
    )
    pg = wb.PanelGrid(
        runsets=[wb.Runset(project=project)],
        panels=[
            wb.ParallelCoordinatesPlot(
                columns=[wb.PCColumn(f"c::{p}") for p in param_space]
                + [wb.PCColumn(metric)],
            ),
            wb.ParameterImportancePlot(with_respect_to=metric),
            wb.ScatterPlot(x="created", y=metric),
        ],
    )
    # per-metric line plots + best-config block (reference
    # `ray_tune/wandb.py:85-214`). Line plots only make sense when trials
    # replayed per-step history — single-point runs render nothing a
    # scatter doesn't.
    blocks = [pg]
    if any(t.get("history") for t in trials):
        metric_names = sorted(
            {k for t in trials for row in t.get("history", ()) for k in row}
            - {metric}
        )
        line_panels = [
            wb.LinePlot(x="_step", y=[m], smoothing_factor=0.5)
            for m in [metric, *metric_names][:12]
        ]
        blocks.append(
            wb.PanelGrid(runsets=[wb.Runset(project=project)], panels=line_panels)
        )
    blocks.append(wb.MarkdownBlock(text=f"**Best config**\n```\n{best}\n```"))
    report.blocks = blocks
    report.save()
