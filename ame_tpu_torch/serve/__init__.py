"""HTTP serving layer of the port (``serve/server.py``): the reference web
client's contract, jobs run by ``api.process_audio`` on the card."""
