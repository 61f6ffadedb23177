"""Tools of the port that lie on no render path: measurements, inverse
rendering, and the worker processes of the multi-process runs (run with
``python -m raytrace_tpu_torch.tools.<name>``)."""
