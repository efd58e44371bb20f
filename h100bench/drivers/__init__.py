"""One driver per kind of traffic (``traffic/<name>.json``'s ``kind``).

A driver module holds ``Driver(cell, seed, device, trace)``:

* ``setup()`` builds the program from the configuration, draws its
  weights and the traffic from the seed, and warms up every shape;
* ``run_unit()`` runs one timed unit and returns the work items it
  completed (frames, scenes, steps);
* ``end_to_end(seconds, items)`` gives the cell's end-to-end metrics of
  the window;
* ``release()`` frees the program's state, keeping what the check reads;
* ``reference(lower)`` runs the plain reference on the same inputs (one
  precision lower with ``lower``, the control) and ``readings(program,
  reference)`` compares two such records number by number.
"""
