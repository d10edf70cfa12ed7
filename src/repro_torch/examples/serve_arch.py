"""Serve a (reduced) assigned architecture with batched greedy decoding
through the KV-cache path (the counterpart of ``examples/serve_arch.py``;
the port serves the dense and VLM families).

    python -m repro_torch.examples.serve_arch [--device cpu] --arch yi-6b
"""
from __future__ import annotations

import sys

from repro_torch.launch.arch_demo import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
