"""Training: the data pipelines, the trainer, its summaries, the crash
supervisor and the standalone prior fitter (counterpart of nic_tpu/train)."""
