"""Scene configuration, asset ingest and the SceneTensors scene."""
