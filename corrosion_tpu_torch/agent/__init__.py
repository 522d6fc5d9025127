"""The host agent (port of ``corrosion_tpu.agent``): ``runtime`` (the
node: ``Agent``, ``AgentConfig``) and the host modules it runs on —
``storage`` (the CRDT storage engine and its batched apply), ``pack``
(the value codec, native where the host module builds), ``bookkeeping``,
``members``, ``transport``, ``tls``, ``wire``, ``writes``, ``schema``,
``snapshot``, ``tracing``, ``recorder``, ``health``, ``locks`` and
``metrics`` — and its surfaces: ``http`` (the HTTP API), ``pubsub``
(subscriptions), ``swim_foca``, ``mux``, ``pg`` over ``pgparse``,
``pgsql`` and ``sqlstate`` (the PostgreSQL wire) and ``admin`` (the
admin socket) —
with ``testing`` (loopback and offline agents), ``det`` (the
deterministic cluster) and ``submatch`` (the subscription matcher's
core); copies of the reference's modules re-rooted on this package."""
