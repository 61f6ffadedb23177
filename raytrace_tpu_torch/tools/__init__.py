"""Measurement tools of the port that lie on no render path (run with
``python -m raytrace_tpu_torch.tools.<name>``)."""
