"""Model code of the port: the decoder LM the RAG generation stage runs."""
