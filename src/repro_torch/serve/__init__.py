"""kNN-LM serving of the port: flat datastores (``retrieval``) and the
continuous-batching front with deadlines and load shedding (``engine``)."""
