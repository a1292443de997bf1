"""PIR-RAG core: PRNG, LWE, PIR protocol, clustering, packing, pipeline."""
