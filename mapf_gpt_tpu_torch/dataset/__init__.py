"""Expert data: the LaCAM* bridge, dataset generation, the solver CLI and
the Hub download (the port of ``mapf_gpt_tpu/dataset``)."""
