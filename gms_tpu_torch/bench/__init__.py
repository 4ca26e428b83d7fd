"""Benchmark entry points — one module per algorithm, mirroring gms_tpu/bench/.

Run as:  python -m gms_tpu_torch.bench.triangle_count -g kronecker 16 -n 3 -v
"""
