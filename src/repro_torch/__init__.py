"""PIR-RAG on PyTorch and CUDA: the Hopper port of the ``repro`` package.

Module paths mirror ``repro`` so every file has a twin to be held against.
The package imports torch and numpy only.  Every entry point takes an
explicit ``device`` and runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card it raises instead of falling back.
"""
