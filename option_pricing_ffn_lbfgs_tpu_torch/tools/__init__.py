"""Scripts run on the card: the benchmark (``bench``) and its error
ablation (``error_ablation``), the measurement tool (``ab_parent``), the
surrogate's training pipeline (``train_pipeline``), the graft-entry twin
(``graft_entry``) and the multi-process check it shares with the tests
(``dist_check``), the drivers ``bench_scaling``, ``profile_search``,
``bench_raw_draws`` and ``make_results``, the L-BFGS trip's checks
(``trip_check``: K4/K5 against their plain pair; ``hybrid_soak``: the
error word over many hybrid calls) and the LM trip's (``lm_trip_check``:
K6/K7 and their fused modes against theirs), and whether the training
path repeats its outcome across processes (``train_repeat``); nothing on
a calibration path imports them."""
