"""Scripts run on the card: the benchmark (``bench``) and its error
ablation (``error_ablation``), the measurement tool (``ab_parent``) and the
surrogate's training pipeline (``train_pipeline``); nothing on a
calibration path imports them."""
