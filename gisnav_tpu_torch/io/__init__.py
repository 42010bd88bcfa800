"""Mock-GPS output encoders: NMEA sentences, u-blox NavPVT, PX4 uORB
SensorGps (counterpart of ``gisnav_tpu/io``). Pure functions, so every
encoder is testable alone; the node layer and ``io.serial_bridge`` attach
the transports.
"""
from gisnav_tpu_torch.io.nmea import (  # noqa: F401
    decimal_to_nmea,
    make_gga,
    make_gsa,
    make_gst,
    make_gsv,
    make_hdt,
    make_rmc,
    make_vtg,
    make_zda,
    nmea_checksum,
    render_sentence,
    sentences_for_fix,
)
from gisnav_tpu_torch.io.ubx import (  # noqa: F401
    make_nav_pvt,
    unix_to_gps_time,
)
from gisnav_tpu_torch.io.uorb import (  # noqa: F401
    SENSOR_GPS_DEVICE_ID,
    make_sensor_gps,
)
