"""The DMTet stage's eval and test renders report K7's tile cap.

``DMTetTrainer.render_view`` returns the view's fullest tile (K7's count
before its tile_cap cut), and ``main``'s summary lists every eval and test
view whose fullest tile passed the cap (``view_tile_cut``), as
``tile_cut_steps`` lists the training steps.  Here the cap is lowered so
that a tiny CPU run's views pass it.
"""

import torch

from dreamfusion_tpu_torch.main import main
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer

torch.set_num_threads(2)
FLAGS = ["--guidance", "oracle", "--backbone", "triplane", "--seed", "0",
         "--lambda_3d_normal_smooth", "0", "--dmtet", "--tet_grid_size",
         "16", "--iters", "2", "--w", "2", "--h", "2",
         "--triplane_resolution", "16", "--triplane_channels", "4",
         "--grid_size", "16", "--hidden_dim", "16", "--dataset_size_train",
         "1", "--eval_interval", "2", "--dataset_size_valid", "2",
         "--dataset_size_test", "2", "--H", "24", "--W", "24", "--ckpt",
         "scratch", "--device", "cpu"]


def _run(tmp_path, monkeypatch, cap):
    orig = DMTetTrainer.__init__

    def init(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        if cap is not None:
            self.dmtet_renderer.tile_cap = cap

    monkeypatch.setattr(DMTetTrainer, "__init__", init)
    return main(FLAGS + ["--workspace", str(tmp_path / "ws")])


def test_eval_and_test_views_over_the_tile_cap_are_listed(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """One eval (2 views, at step 2) and the 2-frame test: each view's
    fullest tile, and the views over a lowered cap named in the summary
    and the log; at the kernel's cap none."""
    out = _run(tmp_path, monkeypatch, None)
    views = out["view_tile_max"]
    assert [v for v, _ in views] == ["eval step 2 view 0",
                                     "eval step 2 view 1", "test view 0",
                                     "test view 1"]
    assert all(n > 0 for _, n in views) and out["view_tile_cut"] == []
    low = min(n for _, n in views)
    capsys.readouterr()
    out = _run(tmp_path / "low", monkeypatch, low - 1)
    assert out["tile_cap"] == low - 1
    assert out["view_tile_cut"] == [v for v, n in out["view_tile_max"]
                                    if n > low - 1]
    assert len(out["view_tile_cut"]) == 4
    assert "eval/test views cut a tile's list" in capsys.readouterr().out
