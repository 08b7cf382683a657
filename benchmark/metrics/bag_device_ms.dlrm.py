"""bag_device_ms.dlrm (ms; layer: embedding bags): milliseconds a step in
which the card ran an operation of DLRM's embedding bags: in the forward
between the port's unit marks ``bags_forward`` and ``bags_forward_end``
(the row gather of every id and the sums of each field's bag), in the
backward between ``bags_backward`` (the pooled gradient comes) and
``bags_backward_end`` (the table's sparse gradient has been made: the sort,
the numbering of the distinct rows and their sums), as
``benchmark/units.py`` reads a unit. The table's update, row-wise Adagrad,
lies in the optimizer's section, outside. Nothing read where the trace
holds no whole stretches of those marks."""

from benchmark import units


def read(s: dict):
    return units.unit_ms(s, "bags")
