"""The apps (counterpart of ``pagnerf_tpu/app``): the offline orbit renderer
behind ``--render-views`` and the HTTP viewer behind ``--viewer``."""
