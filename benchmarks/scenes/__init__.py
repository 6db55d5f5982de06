"""Frozen scene inputs: the meshes and textures every cell renders, made by
the benchmark itself and handed alike to the port and to the reference
(``harness/program.scene_inputs``).  A configuration's ``scene.generator``
names the module here whose ``inputs(scene)`` makes them."""
