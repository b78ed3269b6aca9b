"""The live viewer on the port: ``backend`` (the scene, its stepping and the
JSON snapshots, no web layer) and ``app`` (the routes and the engine thread
over the JAX package's page, ``app/templates`` and ``app/static``)."""
