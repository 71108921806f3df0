"""The mood CNN (inference) and its checkpoint reader (port of
``ame_tpu/models``)."""
