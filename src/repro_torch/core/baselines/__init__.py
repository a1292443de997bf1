"""The paper's baseline private-search architectures (twins of
``repro/core/baselines``): Tiptoe-style private scoring (`tiptoe`),
graph-PIR traversal (`graph_pir`) and the per-document content PIR both
owe for RAG (`common.DocContentPIR`)."""
