"""Serving example: continuous batching over the BTT-style paged KV cache
with transit tiering (eager page-out of finished sequences, conditional
bypass under pool pressure) and, with ``--spill-volume``, the full KV
paging story: suspended sessions' packed pages descend past the host
tier onto a striped async volume as content-deduplicated atomic records,
and decode-ahead prefetch restores them before resume.

    PYTHONPATH=src python examples/serve_paged.py
    PYTHONPATH=src python examples/serve_paged.py --pool-pages 4  # pressure
    PYTHONPATH=src python examples/serve_paged.py --spill-volume \\
        --host-pages 2 --suspend-every 4           # KV paging via volume
"""

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
