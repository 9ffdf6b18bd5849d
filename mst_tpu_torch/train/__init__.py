"""Training and inference entry points of the port: `trainer` (the fused
train step, the fit loop), `cli` (`python -m mst_tpu_torch.train`) and
`predictor` (`make_predict_fn`)."""
