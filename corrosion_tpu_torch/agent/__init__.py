"""The host agent (port of ``corrosion_tpu.agent``): ``runtime`` (the
node: ``Agent``, ``AgentConfig``) and the host modules it runs on —
``storage`` (the CRDT storage engine and its batched apply), ``pack``
(the value codec's Python twins), ``bookkeeping``, ``members``,
``transport``, ``tls``, ``wire``, ``writes``, ``schema``, ``snapshot``,
``tracing``, ``recorder``, ``health``, ``locks`` and ``metrics`` —
with ``testing`` (loopback and offline agents), ``det`` (the
deterministic cluster) and ``submatch`` (the subscription matcher's
core); copies of the reference's modules re-rooted on this package."""
